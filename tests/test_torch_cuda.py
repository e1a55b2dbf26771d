"""The fused_pa CUDA kernel against its plain PyTorch version, on the card.

Marked ``gpu``; every test takes the ``cuda`` fixture, which skips when
there is no card (decided at run time, never at import, so that every test
worker collects the same tests). On a machine with an H100 (``--noconftest``
skips ``tests/conftest.py``, which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from mimo_ofdm_tpu_torch.kernels import fused_pa
from mimo_ofdm_tpu_torch.models import link
from mimo_ofdm_tpu_torch.utils import config

pytestmark = pytest.mark.gpu

KERNEL = fused_pa.fused_ifft_pa_fft


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).to(torch.complex128))
                 / torch.linalg.vector_norm(b.to(torch.complex128)))


def _both(xr, xi, sat, coeff=0.0, **kw):
    """Kernel output, then the plain version on the same CUDA inputs."""
    before = KERNEL.launches
    kr, ki = KERNEL(xr, xi, sat, coeff, **kw)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    rows = xr.shape[:-1]
    sat_t = torch.broadcast_to(torch.as_tensor(sat, dtype=torch.float32, device=xr.device), rows)
    coeff_t = torch.broadcast_to(torch.as_tensor(coeff, dtype=torch.float32, device=xr.device), rows)
    pr, pi = fused_pa.fused_ifft_pa_fft_plain(xr, xi, sat_t, coeff_t, **kw)
    return torch.complex(kr.float(), ki.float()), torch.complex(pr.float(), pi.float())


@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048, 4096])
def test_sc_mode_f32_all_sizes(cuda, n_fft):
    g = torch.Generator(device=cuda).manual_seed(n_fft)
    n_sc = n_fft // 2
    xr = torch.randn(24, n_sc, generator=g, device=cuda)
    xi = torch.randn(24, n_sc, generator=g, device=cuda)
    sat = torch.rand(24, generator=g, device=cuda) + 0.1
    k, p = _both(xr, xi, sat, pa_model="softlim", n_fft=n_fft, mode="sc")
    assert _rel(k, p) < 1e-5


def test_full_mode_f32(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    xr = torch.randn(256, 4096, generator=g, device=cuda)
    xi = torch.randn(256, 4096, generator=g, device=cuda)
    k, p = _both(xr, xi, 1.5, pa_model="softlim", n_fft=4096, mode="full")
    assert _rel(k, p) < 1e-5
    k, _ = _both(xr * 0.01, xi * 0.01, 1e6, pa_model="softlim", n_fft=4096, mode="full")
    assert _rel(k, torch.complex(xr, xi) * 0.01) < 1e-5


def test_sc_mode_bf16(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    xr = torch.randn(64 * 8, 2048, generator=g, device=cuda).bfloat16()
    xi = torch.randn(64 * 8, 2048, generator=g, device=cuda).bfloat16()
    k, p = _both(xr, xi, 0.5, pa_model="softlim", n_fft=4096, mode="sc")
    assert _rel(k, p) < 1e-2


@pytest.mark.parametrize("model", ["none", "rapp", "toi"])
def test_other_pa_models(cuda, model):
    g = torch.Generator(device=cuda).manual_seed(3)
    xr = torch.randn(32, 512, generator=g, device=cuda)
    xi = torch.randn(32, 512, generator=g, device=cuda)
    coeff = torch.rand(32, generator=g, device=cuda) * 0.1
    k, p = _both(xr, xi, 0.7, coeff, pa_model=model, n_fft=1024, mode="sc")
    assert _rel(k, p) < 1e-5


def test_rejects_non_contiguous(cuda):
    x = torch.zeros(4, 1024, device=cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        KERNEL(x, x, 1.0, n_fft=1024)


def test_frame_kernel_equals_plain(cuda):
    """A small f32 frame through the kernel and through the plain version
    (forced on CUDA tensors) gives the same counters."""
    cfg = config.LinkConfig(
        modem=config.ModemConfig(n_fft=1024, n_sub_carr=512),
        array=config.ArrayConfig(n_elements=8),
        channel=config.ChannelConfig(model="rayleigh"),
        channel_storage="float32", mxu_fft_storage="float32")
    out = {}
    for alg in ("cnc", "mcnc"):
        c = cfg.replace(rx=dataclasses.replace(cfg.rx, algorithm=alg))
        frame = link.make_frame_fn(c, 2, device=cuda)
        draws = link.FrameDraws.draw(c, 8, torch.Generator(device=cuda).manual_seed(4))
        for plain in (False, True):
            KERNEL.force_plain = plain
            try:
                r = frame(15.0, draws)
            finally:
                KERNEL.force_plain = False
            out[alg, plain] = np.concatenate([r.clean_err.cpu().numpy()[:, None],
                                              r.dist_err.cpu().numpy()], axis=1)
        np.testing.assert_array_equal(out[alg, False], out[alg, True])
