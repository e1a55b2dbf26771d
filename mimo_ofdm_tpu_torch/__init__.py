"""mimo_ofdm_tpu_torch — the PyTorch/CUDA port of ``mimo_ofdm_tpu``.

The JAX package ``mimo_ofdm_tpu`` stays the reference; this package mirrors
its layout (``ops/``, ``models/``, ``kernels/``, ``parallel/``,
``experiments/``, ``utils/``) and its public names. Each public JAX name
and function parameter has a counterpart of the same name here, or an
entry with its counterpart or reason in the name map that
``tests/test_torch_api_coverage.py`` checks.

* Plain functions on tensors with a leading batch dimension where JAX used
  ``vmap``; an explicit ``device`` and explicit ``torch.Generator`` objects
  where JAX used keys.
* Entry points (``models.link.make_frame_fn`` / ``make_round_fn``) run on
  ``cuda`` unless the caller passes ``device="cpu"``; with no card they
  raise instead of falling back.
* The fused IFFT -> PA -> FFT chain is a hand-written CUDA kernel
  (``csrc/fused_pa.cu``, wrapper ``kernels/fused_pa.py``); its plain
  PyTorch version serves CPU tensors only.

Nothing here imports JAX or the JAX package.
"""
