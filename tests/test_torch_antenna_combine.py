"""The planar transmitter's antenna combine ``sum_ant H o X``
(``kernels/antenna_combine.py``): the wrapper on CPU tensors and on float32
planes against the eager expression, its checks, the ``tx.combine`` spans;
and, marked ``gpu`` (the ``cuda`` fixture skips without a card, decided at
run time), the CUDA kernel against the eager expression, a model of its sum
order and a float64 sum, alone and inside the bf16 frames. On a machine with an H100:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_antenna_combine.py -q
"""

import json
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from mimo_ofdm_tpu_torch.kernels import antenna_combine as ac
from mimo_ofdm_tpu_torch.kernels import fused_pa
from mimo_ofdm_tpu_torch.models import link
from mimo_ofdm_tpu_torch.utils import config, spans

COMBINE = ac.antenna_combine
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def eager(hr, hi, fr, fi):
    """The planar TX's combine as ``link_planar.tx_propagate`` wrote it
    before the kernel."""
    def f32sum(x, dim):
        return x.sum(dim, dtype=torch.float32)
    return torch.complex(f32sum(hr * fr - hi * fi, -2), f32sum(hr * fi + hi * fr, -2))


def terms(hr, hi, fr, fi):
    """Each antenna's term, rounded as the eager expression rounds it, in
    float32 ``[B, n_ant, n_sc]`` (re, im)."""
    return (hr * fr - hi * fi).float(), (hr * fi + hi * fr).float()


def kernel_order(hr, hi, fr, fi):
    """The kernel's float32 sum order (``csrc/antenna_combine.cu``): each
    subcarrier's terms summed from 0 in antenna order, each addition a
    float32 tensor addition."""
    tr, ti = terms(hr, hi, fr, fi)
    re, im = torch.zeros_like(tr[..., 0, :]), torch.zeros_like(ti[..., 0, :])
    for a in range(tr.shape[-2]):
        re, im = re + tr[..., a, :], im + ti[..., a, :]
    return torch.complex(re, im)


def planes(batch, n_ant, n_sc, device="cpu", seed=0, shared_h=False):
    """Random bf16 planes ``hr, hi, fr, fi``; ``shared_h``: H one frame
    ``expand``ed over the batch (batch stride 0)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def plane(b):
        return torch.randn(b, n_ant, n_sc, generator=g, device=device).bfloat16()

    if shared_h:
        hr, hi = (plane(1).expand(batch, -1, -1) for _ in range(2))
    else:
        hr, hi = plane(batch), plane(batch)
    return hr, hi, plane(batch), plane(batch)


def bits(z):
    return torch.view_as_real(z).contiguous().view(torch.int32)


# --- the wrapper on CPU tensors ----------------------------------------------

@pytest.mark.parametrize("shared_h", [False, True])
@pytest.mark.parametrize("batch,n_ant,n_sc", [(1, 1, 256), (5, 2, 512), (16, 8, 1024),
                                              (3, 64, 2048), (2, 64, 256)])
def test_wrapper_on_cpu_equals_the_eager_expression(batch, n_ant, n_sc, shared_h):
    hr, hi, fr, fi = planes(batch, n_ant, n_sc, seed=n_ant + n_sc, shared_h=shared_h)
    assert (hr.stride(0) == 0) == (shared_h and batch > 1)
    before = COMBINE.launches
    got = COMBINE(hr, hi, fr, fi)
    assert got.dtype == torch.complex64 and got.shape == (batch, n_sc)
    assert torch.equal(bits(got), bits(eager(hr, hi, fr, fi)))
    assert COMBINE.launches == before            # the plain version launches nothing


def test_float32_planes_take_the_eager_expression():
    """float32 planes, which the kernel does not take, combine as the eager
    expression bit for bit, at any strides (here the strided real and imag
    views of complex planes), and launch nothing."""
    hr, hi, fr, fi = (t.float() for t in planes(4, 8, 64, seed=1))
    x = torch.complex(fr, fi)
    before = COMBINE.launches
    for args in ((hr, hi, fr, fi), (hr, hi, x.real, x.imag)):
        assert torch.equal(bits(COMBINE(*args)), bits(eager(*args)))
    assert COMBINE.launches == before


def _bad_calls():
    hr, hi, fr, fi = planes(4, 8, 64)
    wide = planes(8, 8, 64)[0]
    return {
        "complex": (torch.complex(hr.float(), hi.float()),) * 2 + (fr, fi),
        "one float32 plane": (hr, hi, fr.float(), fi),
        "shapes differ": (hr, hi, fr[:, :4], fi[:, :4]),
        "two dims": (hr[0], hi[0], fr[0], fi[0]),
        "batch stride 2 n_ant n_sc": (wide[::2], hi, fr, fi),
        "rows not contiguous": (hr.transpose(1, 2).contiguous().transpose(1, 2), hi, fr, fi),
        "hr and hi strides differ": (hr[:1].expand(4, -1, -1), hi, fr, fi),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        COMBINE(*_bad_calls()[case])


@pytest.mark.parametrize("n_ant", [1, 2, 64])
def test_the_order_model_is_the_eager_sum(n_ant):
    """The model of the kernel's sum order equals the eager expression bit
    for bit where one or two terms leave no order, and within float32
    rounding at 64 antennas."""
    p = planes(3, n_ant, 256, seed=n_ant)
    if n_ant <= 2:
        assert torch.equal(bits(kernel_order(*p)), bits(eager(*p)))
    else:
        np.testing.assert_allclose(kernel_order(*p).numpy(), eager(*p).numpy(),
                                   rtol=1e-5, atol=1e-5)


N_ANT, BATCH, N_ITERS = 8, 3, 2


def _frame_spans(alg: str, storage: str, device="cpu"):
    """The spans of one small Rayleigh frame, and the combine kernel's
    launches in it."""
    cfg = config.LinkConfig(modem=config.ModemConfig(n_fft=256, n_sub_carr=128),
                            array=config.ArrayConfig(n_elements=N_ANT),
                            channel=config.ChannelConfig(model="rayleigh"),
                            rx=config.RxConfig(algorithm=alg, max_cnc_iters=N_ITERS),
                            channel_storage=storage, mxu_fft_storage=storage)
    frame_fn = link.make_frame_fn(cfg, N_ITERS, device=device)
    draws = frame_fn.draw(BATCH, torch.Generator(device=device).manual_seed(3))
    before = COMBINE.launches
    spans.enable()
    try:
        frame_fn(15.0, draws)
    finally:
        spans.disable()
    return spans.collect(), COMBINE.launches - before


def _combines(alg: str) -> int:
    """The combines of a frame: one for the TX and one for each MCNC pass."""
    return 1 + N_ITERS + 1 if alg == "mcnc" else 1


@pytest.mark.parametrize("storage", ["bfloat16", "float32"])
@pytest.mark.parametrize("alg", ["cnc", "mcnc"])
def test_tx_combine_span_counts_the_frames_the_kernel_combined(alg, storage):
    """A ``tx.combine`` span, with no counts, around every combine of the
    frame; on the CPU the combine launches nothing, on bf16 planes as on
    float32 ones (the launches on bf16 CUDA planes: ``test_frame_launches``)."""
    rec, launches = _frame_spans(alg, storage)
    combines = [s for s in rec if s.name == "tx.combine"]
    assert len(combines) == _combines(alg) and not any(s.counts for s in combines)
    assert Counter(s.name for s in rec)["frame"] == 1
    assert launches == 0


# --- the kernel on the card --------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launch(*p):
    before = COMBINE.launches
    out = COMBINE(*p)
    torch.cuda.synchronize()
    assert COMBINE.launches == before + 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shared_h", [False, True])
@pytest.mark.parametrize("batch", [1, 7, 512])
@pytest.mark.parametrize("n_ant", [1, 2])
def test_kernel_equals_the_eager_expression_at_one_and_two_antennas(cuda, n_ant, batch,
                                                                   shared_h):
    """With one or two terms the float32 sum's order cannot matter, so this
    pins each term's bf16 roundings: bit for bit."""
    p = planes(batch, n_ant, 2048, cuda, seed=batch + n_ant, shared_h=shared_h)
    assert torch.equal(bits(_launch(*p)), bits(eager(*p)))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 7, 512])
def test_kernel_at_64_antennas_within_the_float32_sum_bound(cuda, batch):
    """``[B, 64, 2048]``: the kernel equals the model of its own sum order
    bit for bit, and lies within ``n_ant 2^-24 sum|terms|`` of a float64 sum
    of the same bf16-rounded terms (recursive float32 summation of n terms
    errs by at most (n - 1) 2^-24 sum|terms|)."""
    p = planes(batch, 64, 2048, cuda, seed=batch)
    got = _launch(*p)
    assert torch.equal(bits(got), bits(kernel_order(*p)))
    tr, ti = terms(*p)
    for part, t in ((got.real, tr), (got.imag, ti)):
        exact = t.double().sum(-2)
        tol = 64 * 2.0 ** -24 * t.double().abs().sum(-2)
        assert bool(((part.double() - exact).abs() <= tol).all())


@pytest.mark.gpu
def test_kernel_is_deterministic_and_batch_independent(cuda):
    """Two calls on the same inputs give the same bits, and a frame gives
    the same bits whether it is combined among 512 frames or among 7."""
    p = planes(512, 64, 2048, cuda, seed=11)
    first, second = _launch(*p), _launch(*p)
    assert torch.equal(bits(first), bits(second))
    few = _launch(*(t[:7] for t in p))
    assert torch.equal(bits(few), bits(first[:7]))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 7, 512])
def test_shared_channel_equals_its_contiguous_copy(cuda, batch):
    """H ``expand``ed over the batch (stride 0, read as it is) gives the bits
    of its ``.contiguous()`` copy."""
    hr, hi, fr, fi = planes(batch, 64, 2048, cuda, seed=3, shared_h=True)
    assert hr.stride(0) == 0 or batch == 1
    assert torch.equal(bits(_launch(hr, hi, fr, fi)),
                       bits(_launch(hr.contiguous(), hi.contiguous(), fr, fi)))


@pytest.mark.gpu
def test_unaligned_rows_and_ragged_widths_take_the_scalar_path(cuda):
    """Planes that start off a 16-byte boundary, or whose n_sc is not a
    multiple of 8, run one subcarrier a thread: the same bits as the model
    of the sum order, and as the aligned planes."""
    p = planes(9, 64, 2048, cuda, seed=5)
    flat = [torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda) for t in p]
    off = [f[1:].view(t.shape) for f, t in zip(flat, p)]
    for o, t in zip(off, p):
        o.copy_(t)
    assert off[0].data_ptr() % 16
    assert torch.equal(bits(_launch(*off)), bits(_launch(*p)))
    ragged = planes(5, 64, 100, cuda, seed=6)
    assert torch.equal(bits(_launch(*ragged)), bits(kernel_order(*ragged)))


# one call of the wrapper under the profiler, in a process of its own: run
# here, a profiler session was seen to leave the next one, in another test
# of the same process, without device events
_PROFILE_ONE_CALL = """
import json, torch
from mimo_ofdm_tpu_torch.kernels import antenna_combine as ac
p = [torch.randn(64, 64, 2048, device="cuda").bfloat16() for _ in range(4)]
ac.antenna_combine(*p)
torch.cuda.synchronize()
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    ac.antenna_combine(*p)
    torch.cuda.synchronize()
print(json.dumps({e.key: e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA}))
"""


@pytest.mark.gpu
def test_one_launch_of_a_kernel_not_named_as_the_chain(cuda):
    """A call is one device kernel and nothing else, and its name does not
    hold ``fused_ifft_pa_fft``, which the benchmark counts as the chain."""
    proc = subprocess.run([sys.executable, "-c", _PROFILE_ONE_CALL], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    kernels = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(kernels.values()) == [1], kernels
    name = next(iter(kernels))
    assert "antenna_combine" in name and "fused_ifft_pa_fft" not in name


@pytest.mark.gpu
def test_kernel_raises_on_planes_of_two_devices(cuda):
    hr, hi, fr, fi = planes(2, 8, 64, cuda)
    with pytest.raises(ValueError):
        COMBINE(hr.cpu(), hi, fr, fi)


@pytest.mark.gpu
def test_kernel_resources(cuda):
    """Neither instantiation spills, and each keeps 4 blocks an SM."""
    rows = ac.kernel_resources()
    assert len(rows) == 2 and all(r["local_bytes"] == 0 for r in rows)
    assert all(r["blocks_per_sm"] >= 4 for r in rows)


def _bf16_rayleigh(alg: str, storage: str = "bfloat16") -> config.LinkConfig:
    return config.LinkConfig(
        modem=config.ModemConfig(n_fft=1024, n_sub_carr=512),
        array=config.ArrayConfig(n_elements=8),
        channel=config.ChannelConfig(model="rayleigh"),
        rx=config.RxConfig(algorithm=alg),
        channel_storage=storage, mxu_fft_storage=storage)


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["bfloat16", "float32"])
@pytest.mark.parametrize("alg", ["cnc", "mcnc"])
def test_frame_launches(cuda, alg, storage):
    """A bf16 frame combines through the kernel once for the TX and once
    for each MCNC pass (2 iterations: 3 passes); float32 planes never."""
    _, launches = _frame_spans(alg, storage, cuda)
    assert launches == (_combines(alg) if storage == "bfloat16" else 0)
    cfg = _bf16_rayleigh(alg, storage)
    frame = link.make_frame_fn(cfg, 2, device=cuda)
    draws = link.FrameDraws.draw(cfg, 8, torch.Generator(device=cuda).manual_seed(2))
    before = COMBINE.launches
    frame(15.0, draws)
    torch.cuda.synchronize()
    want = (1 + 3 if alg == "mcnc" else 1) if storage == "bfloat16" else 0
    assert COMBINE.launches - before == want


@pytest.mark.gpu
@pytest.mark.parametrize("alg", ["cnc", "mcnc"])
def test_bf16_rayleigh_frames_within_one_percent_of_the_eager_combine(cuda, alg, monkeypatch):
    """The bf16 Rayleigh frame with the kernel and with the eager combine
    (the plain version, patched in before the frame is built) on the same
    draws: error totals within 1%, the bound of a float32 sum order on the
    bf16 path (``ROADMAP.md``'s ground rules allow 5%): the sums differ in
    their last float32 bits, which moves a decision only where a symbol
    lies within that of a boundary, and the receiver's passes carry such a
    decision on."""
    from mimo_ofdm_tpu_torch.models import link_planar
    cfg = _bf16_rayleigh(alg)
    draws = link.FrameDraws.draw(cfg, 64, torch.Generator(device=cuda).manual_seed(8))

    def counters():
        r = link.make_frame_fn(cfg, 2, device=cuda)(15.0, draws)
        return np.concatenate([r.clean_err.cpu().numpy()[:, None], r.dist_err.cpu().numpy()],
                              axis=1)

    before = COMBINE.launches
    kernel = counters()
    assert COMBINE.launches > before
    monkeypatch.setattr(link_planar, "antenna_combine", ac.antenna_combine_plain)
    before = COMBINE.launches
    plain = counters()
    assert COMBINE.launches == before
    assert kernel[:, 1].sum() > 0
    assert np.array_equal(kernel[:, 0], plain[:, 0])         # the clean run has no combine
    assert abs(int(plain[:, 1:].sum()) - int(kernel[:, 1:].sum())) <= 0.01 * kernel[:, 1:].sum()


@pytest.mark.gpu
def test_fused_kernel_count_is_not_the_combines(cuda):
    """The combine kernel is no ``fused_ifft_pa_fft`` launch: an MCNC frame
    still counts 1 + 3 of those."""
    cfg = _bf16_rayleigh("mcnc")
    frame = link.make_frame_fn(cfg, 2, device=cuda)
    draws = link.FrameDraws.draw(cfg, 8, torch.Generator(device=cuda).manual_seed(9))
    before = fused_pa.fused_ifft_pa_fft.launches
    frame(15.0, draws)
    assert fused_pa.fused_ifft_pa_fft.launches - before == 1 + 3

