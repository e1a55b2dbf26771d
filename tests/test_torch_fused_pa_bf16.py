"""The bf16 layouts' arithmetic (mimo_ofdm_tpu_torch/kernels/fused_pa.py::
fused_ifft_pa_fft_bf16, the plain version of the tensor-core kernel in
csrc/fused_pa.cu) held against the JAX package's bf16 chains on the CPU:

* against ``ops/mxu_fft.py::fused_sc_ifft_pa_fft_planar_io`` (``sc``) and
  ``fused_ifft_pa_fft_planar`` (``full``) at ``storage="bfloat16"``, within
  1e-2 relative L2, the -40 dB of bf16 storage (tests/test_mxu_fft.py:
  107-130; 0.0071-0.0085 measured: the two round at different places);
* each one's error against the exact float32 chain
  (``fused_ifft_pa_fft_plain`` on the float32 input), the port's no larger
  than JAX's (measured: port 0.0037-0.0052, JAX 0.0064-0.0078 at n_fft 256
  and 1024): the port rounds only the products' operands, JAX also its
  Karatsuba sums and twiddles;
* the interleaved bf16 layout bit for bit the bf16 planes;
* the tensor-core schedule's exchanges: every 8 x 8 matrix of ``stmatrix``
  and ``ldmatrix`` on 8 distinct bank groups, each side of an exchange
  holding the points the other side expects, each warp reading only what
  it wrote where the kernel only syncs the warp;
* a Rayleigh frame at bf16 storage whose error totals agree with JAX's
  within the rule of tests/test_mxu_fft.py:107-130.

The card holds the kernel to this plain version in tests/test_torch_cuda.py
and chip_smoke.py.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mimo_ofdm_tpu.models import link_planar as jax_planar
from mimo_ofdm_tpu.models.link import link_static as jax_link_static
from mimo_ofdm_tpu.ops import bits as jax_bits
from mimo_ofdm_tpu.ops import mxu_fft
from mimo_ofdm_tpu.ops import pa as jpa
from mimo_ofdm_tpu.utils import config as jax_config

from mimo_ofdm_tpu_torch.kernels import fused_pa
from mimo_ofdm_tpu_torch.models import link
from mimo_ofdm_tpu_torch.utils import config as pt_config

KERNEL = fused_pa.fused_ifft_pa_fft
N_FFTS = [256, 512, 1024, 2048, 4096]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _case(n_fft, mode, model, rows=6):
    rng = np.random.default_rng(n_fft + len(mode) + len(model))
    n_io = n_fft // 2 if mode == "sc" else n_fft
    xr = rng.standard_normal((rows, n_io)).astype(np.float32)
    xi = rng.standard_normal((rows, n_io)).astype(np.float32)
    sat = rng.uniform(0.2, 2.0, rows).astype(np.float32)
    coeff = rng.uniform(0.0, 0.1, rows).astype(np.float32)
    return xr, xi, sat, coeff


def _jax_bf16(xr, xi, sat, coeff, n_fft, mode, model):
    """JAX's bf16 chain on float32 inputs (it casts them to bf16 itself),
    run with x64 off."""
    def pa_fn(pr, pi):
        return jpa.apply_pa_planar(pr, pi, model, jnp.asarray(sat)[:, None, None], 1.1,
                                   jnp.asarray(coeff)[:, None, None])

    with jax.enable_x64(False):
        if mode == "sc":
            jr, ji = jax.jit(lambda a, b: mxu_fft.fused_sc_ifft_pa_fft_planar_io(
                a, b, pa_fn, n_fft, storage="bfloat16"))(jnp.asarray(xr), jnp.asarray(xi))
            return np.asarray(jr, np.float32) + 1j * np.asarray(ji, np.float32)
        x = jnp.asarray(xr + 1j * xi, jnp.complex64)
        return np.asarray(jax.jit(lambda v: mxu_fft.fused_ifft_pa_fft_planar(
            v, pa_fn, storage="bfloat16"))(x))


def _port(fn, xr, xi, sat, coeff, n_fft, mode, model, dtype):
    pr, pi = fn(torch.from_numpy(xr).to(dtype), torch.from_numpy(xi).to(dtype),
                torch.from_numpy(sat), torch.from_numpy(coeff), pa_model=model,
                n_fft=n_fft, mode=mode)
    return pr.float().numpy() + 1j * pi.float().numpy()


@pytest.mark.parametrize("model", ["softlim", "toi"])
@pytest.mark.parametrize("mode", ["sc", "full"])
@pytest.mark.parametrize("n_fft", [256, 1024])
def test_bf16_plain_matches_jax_and_beats_its_error(n_fft, mode, model):
    xr, xi, sat, coeff = _case(n_fft, mode, model)
    jax_out = _jax_bf16(xr, xi, sat, coeff, n_fft, mode, model)
    before = KERNEL.launches
    port = _port(KERNEL, xr, xi, sat, coeff, n_fft, mode, model, torch.bfloat16)
    assert KERNEL.launches == before                  # the CPU runs the plain version
    np.testing.assert_array_equal(port, _port(fused_pa.fused_ifft_pa_fft_bf16, xr, xi, sat,
                                              coeff, n_fft, mode, model, torch.bfloat16))
    exact = _port(fused_pa.fused_ifft_pa_fft_plain, xr, xi, sat, coeff, n_fft, mode, model,
                  torch.float32)
    assert _rel(port, jax_out) < 1e-2
    port_err, jax_err = _rel(port, exact), _rel(jax_out, exact)
    assert port_err <= jax_err, f"port {port_err:.5f} against JAX {jax_err:.5f}"


@pytest.mark.parametrize("mode", ["sc", "full"])
@pytest.mark.parametrize("n_fft", N_FFTS)
def test_interleaved_bf16_equals_planes(n_fft, mode):
    """The complex64 entry at bf16 storage gives the bits of bf16 planes
    through the plane entry, both on the new arithmetic."""
    xr, xi, sat, coeff = _case(n_fft, mode, "softlim", rows=3)
    x = torch.from_numpy(xr + 1j * xi)
    kw = dict(pa_model="softlim", n_fft=n_fft, mode=mode)
    got = fused_pa.fused_ifft_pa_fft_complex(x, torch.from_numpy(sat), torch.from_numpy(coeff),
                                             storage="bfloat16", **kw)
    pr, pi = KERNEL(x.real.bfloat16(), x.imag.bfloat16(), torch.from_numpy(sat),
                    torch.from_numpy(coeff), **kw)
    want = torch.complex(pr.float(), pi.float())
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(want))
    # and not the exact transform's bits: the passes round
    er, ei = fused_pa.fused_ifft_pa_fft_plain(x.real.bfloat16(), x.imag.bfloat16(),
                                              torch.from_numpy(sat), torch.from_numpy(coeff),
                                              **kw)
    assert not torch.equal(pr, er)


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_bf16_plain_within_bf16_of_exact_every_size(n_fft):
    """Every tile count (1, 2, 4, 8, 16: the third pass's block-diagonal
    DFT-R) on a ragged [3, 5] batch, both modes, within 1e-2 of the exact
    chain on the same bf16 input, and the identity PA near the identity."""
    rng = np.random.default_rng(n_fft)
    for mode, n_io in (("sc", n_fft // 2), ("full", n_fft), ("sc", n_fft // 4)):
        xr = torch.from_numpy(rng.standard_normal((3, 5, n_io)).astype(np.float32)).bfloat16()
        xi = torch.from_numpy(rng.standard_normal((3, 5, n_io)).astype(np.float32)).bfloat16()
        sat = torch.from_numpy(rng.uniform(0.2, 2.0, (3, 5)).astype(np.float32))
        kw = dict(pa_model="softlim", n_fft=n_fft, mode=mode)
        pr, pi = fused_pa.fused_ifft_pa_fft_bf16(xr, xi, sat, torch.zeros(3, 5), **kw)
        er, ei = fused_pa.fused_ifft_pa_fft_plain(xr, xi, sat, torch.zeros(3, 5), **kw)
        assert pr.dtype == torch.bfloat16 and pr.shape == (3, 5, n_io)
        got = torch.complex(pr.float(), pi.float()).numpy()
        assert _rel(got, torch.complex(er.float(), ei.float()).numpy()) < 1e-2
    pr, pi = fused_pa.fused_ifft_pa_fft_bf16(xr, xi, 1.0, 0.0, pa_model="none", n_fft=n_fft,
                                             mode="sc")
    x = torch.complex(xr.float(), xi.float()).numpy()
    assert _rel(torch.complex(pr.float(), pi.float()).numpy(), x) < 1e-2


def test_dft_tables_are_the_kernels():
    """The plain version's bf16 DFT matrices, rounded from float64, are the
    bits the kernel packs from its float32 constants (``cos16``), and the
    DFT-16 at float32 precision is the DFT; the twiddle table folds the
    ortho scale into the ``W^(t k)`` section only."""
    for radix in (2, 4, 8, 16):
        for inverse in (True, False):
            big = fused_pa._tensor_dft(radix, inverse).double()
            k = np.arange(16)
            ang = 2 * np.pi * ((k[:, None] * k[None, :]) % 16) / 16
            via_f32 = torch.from_numpy(np.cos(ang).astype(np.float32)).to(torch.bfloat16)
            if radix == 16:
                c = big[:16, :16]
                np.testing.assert_array_equal(c.numpy(), via_f32.double().numpy()
                                              * (np.abs(np.cos(ang)) > 1e-12))
            blocks = (k[:, None] // radix) == (k[None, :] // radix)
            assert not big[:16, :16].numpy()[~blocks].any()
            np.testing.assert_array_equal(big[:16, :16], big[16:, 16:])
            np.testing.assert_array_equal(big[:16, 16:], -big[16:, :16])
    n = 1024
    t, tt = fused_pa.twiddle_table(n), fused_pa.tensor_twiddle_table(n)
    s = fused_pa.schedule(n)
    split = 16 * s.threads
    np.testing.assert_allclose(tt[:split], t[:split] / np.sqrt(n), rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(tt[split:], t[split:])


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_kernel_table_is_the_plain_versions_values(n_fft):
    """The tensor-core kernel's lane-ordered table holds, for each lane's
    accumulator element (row g + 8 (e // 2), point 8 h + 2 q + e % 2), the
    twiddle the plain version applies there, and B fragments that unpack
    to the plain version's bf16 DFT matrices."""
    r, T = n_fft // 256, n_fft // 16
    table = fused_pa.tensor_kernel_table(n_fft)
    nat = fused_pa.tensor_twiddle_table(n_fft)
    w1, w2 = nat[:16 * T], nat[16 * T:]
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    sections = np.split(table, np.cumsum([256 * r, 128 * r, 256, 256 * r, 128]))
    s1, s2, s3, s4 = (sections[0].reshape(r, 8, 32, 2), sections[1].reshape(r, 4, 32, 2),
                      sections[2].reshape(8, 32, 2), sections[3].reshape(r, 8, 32, 2))
    for tile in range(r):
        for h in range(2):
            for e in range(4):
                row, point = g + 8 * (e // 2), 8 * h + 2 * q + e % 2
                np.testing.assert_array_equal(s1[tile, 4 * h + e], w1[point * T + 16 * tile + row])
                np.testing.assert_array_equal(s2[tile, 2 * h + e % 2], w2[point * r + tile])
                np.testing.assert_array_equal(s3[4 * h + e], w2[row * r + point % r])
                np.testing.assert_array_equal(s4[tile, 4 * h + e], w1[row * T + tile + r * point])
    for words, radix in ((sections[4], 16), (sections[5], max(r, 2))):
        w = words.view(np.uint32).reshape(8, 32)
        big = fused_pa._tensor_dft(radix, True)
        for part, first in (("c", 0), ("s", 4)):
            want = big[:16, :16] if part == "c" else big[:16, 16:]
            got = np.zeros((16, 16), np.float32)
            for h in range(2):
                for rr in range(2):
                    k, n = 2 * q + 8 * rr, 8 * h + g
                    for half, kk in ((0, k), (16, k + 1)):
                        bits = ((w[first + 2 * h + rr] >> half) & 0xFFFF).astype(np.uint32) << 16
                        got[kk, n] = bits.view(np.float32)
            np.testing.assert_array_equal(got, want.numpy())


def _banks(chunks):
    """The 16-byte bank groups (of 8) of one 8x8 matrix's 8 chunks."""
    return {int(c) % 8 for c in chunks}


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_tensor_exchanges_are_bank_conflict_free(n_fft):
    """Each side of each exchange addresses every chunk of the row once,
    and each 8x8 matrix of a stmatrix/ldmatrix (lanes 8i .. 8i + 7) hits 8
    distinct bank groups: one wavefront a matrix."""
    s = fused_pa.tensor_schedule(n_fft)
    assert s.tiles == n_fft // 256 and (s.e2_rows is None) == (n_fft == 256)
    tables = [s.e1_rows, s.e1_cols] + ([s.e2_rows, s.e2_cols] if s.tiles > 1 else [])
    for e in tables:
        assert e.shape == (s.tiles, 32)
        np.testing.assert_array_equal(np.sort(e.ravel()), np.arange(n_fft // 8))
        for tile in range(s.tiles):
            for i in range(4):
                assert len(_banks(e[tile, 8 * i:8 * i + 8])) == 8, (n_fft, tile, i)


def _positions(n_fft):
    """Each exchange side's bf16 position in a row's plane of every tile
    element ``[tiles, 16 (row), 16 (point)]``: the kernel's chunk index
    (``csrc/fused_pa.cu``, ``to_smem``/``from_smem``), swizzled, times 8,
    plus the element's place in its chunk. The row side takes a tile row
    ``m`` and the half of its 16 points, the column side a point ``n`` and
    the half of the tile's 16 rows."""
    r = n_fft // 256
    tau, m, n = np.meshgrid(np.arange(r), np.arange(16), np.arange(16), indexing="ij")
    sw = fused_pa.chunk_swizzle
    return {"e1_rows": sw(2 * (16 * tau + m) + (n >> 3)) * 8 + (n & 7),
            "e1_cols": sw(2 * (tau + r * n) + (m >> 3)) * 8 + (m & 7),
            "e2_rows": sw(2 * (m * r + tau) + (n >> 3)) * 8 + (n & 7),
            "e2_cols": sw(2 * (16 * tau + n) + (m >> 3)) * 8 + (m & 7)}


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_tensor_schedule_is_the_chunks_of_the_positions(n_fft):
    """:func:`tensor_schedule`'s lane chunks (lane ``l`` gives row ``l %
    8`` of 8 x 8 matrix ``l // 8``) are the chunks of the positions the
    exchanges below are checked on."""
    s, pos = fused_pa.tensor_schedule(n_fft), _positions(n_fft)
    lane = np.arange(32)
    i, row = lane >> 3, lane & 7
    for name in ("e1", "e2") if s.tiles > 1 else ("e1",):
        rows, cols = getattr(s, f"{name}_rows"), getattr(s, f"{name}_cols")
        for tile in range(s.tiles):
            np.testing.assert_array_equal(
                rows[tile], pos[f"{name}_rows"][tile, row + 8 * (i & 1), 8 * (i >> 1)] // 8)
            np.testing.assert_array_equal(
                cols[tile], pos[f"{name}_cols"][tile, 8 * (i & 1), row + 8 * (i >> 1)] // 8)


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_tensor_exchanges_move_the_right_points(n_fft):
    """What each side of an exchange writes where, the other side reads as
    the points its pass needs: exchange 1 takes pass 1's (column t, point
    k) to pass 2's (column (k, a), point b), t = a + R b; exchange 2 takes
    pass 2's (column (k, a), point c) to pass 3's (column c, point (s, a)),
    k = 16 tile / R + s."""
    r = n_fft // 256
    pos = _positions(n_fft)
    tile, m, n = np.meshgrid(np.arange(r), np.arange(16), np.arange(16), indexing="ij")
    # exchange 1, points named t * 16 + k: the row side is pass 1 (t = 16
    # tile + m, k = n), the column side pass 2 (a = tile, k = m, b = n)
    buf = np.full(n_fft, -1)
    buf[pos["e1_rows"]] = (16 * tile + m) * 16 + n
    np.testing.assert_array_equal(buf[pos["e1_cols"]], (tile + r * n) * 16 + m)
    if r == 1:
        return
    # exchange 2, points named (k R + a) * 16 + c: the row side is pass 2
    # (a = tile, k = m, c = n), the column side pass 3 (c = m, k = 16 tile
    # / R + n // R, a = n % R)
    buf[pos["e2_rows"]] = (m * r + tile) * 16 + n
    np.testing.assert_array_equal(buf[pos["e2_cols"]],
                                  ((16 // r * tile + n // r) * r + n % r) * 16 + m)


def _warp_chunks(s, side):
    """For each of a block's 8 warps, the chunks (16 bytes, over the
    block's row planes) its lanes address on ``side`` of an exchange: warp
    ``w`` holds the block's tiles 2 w and 2 w + 1, tile ``b`` is tile ``b %
    R`` of row ``b // R``, whose plane starts at chunk ``(b // R) *
    n_fft / 8``."""
    return [{int(c) + (b // s.tiles) * (s.n_fft // 8) for b in (2 * w, 2 * w + 1)
             for c in side[b % s.tiles]} for w in range(8)]


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_tensor_exchanges_stay_in_the_warp_where_it_only_syncs_the_warp(n_fft):
    """The kernel orders an exchange with __syncwarp() at R <= 2 and with
    __syncthreads() above: at R <= 2 every chunk a warp reads is one the
    same warp wrote, inside its own rows' planes; at R > 2 some warp reads
    a chunk another warp wrote."""
    s = fused_pa.tensor_schedule(n_fft)
    pairs = [(s.e1_rows, s.e1_cols)] + ([(s.e2_rows, s.e2_cols)] if s.tiles > 1 else [])
    for rows, cols in pairs:
        for written, read in ((rows, cols), (cols, rows)):      # the IFFT, the FFT
            w_chunks, r_chunks = _warp_chunks(s, written), _warp_chunks(s, read)
            local = all(rc == wc for rc, wc in zip(r_chunks, w_chunks))
            assert local == (s.tiles <= 2), (n_fft, local)


# --- a Rayleigh frame at bf16 storage ----------------------------------------

N_FRAMES = 24
N_ITERS = 2
SNR_DB = 12.0


def test_rayleigh_frame_bf16_error_totals_match_jax():
    """The planar Rayleigh frame (64-QAM, n_fft 256, 8 antennas, MCNC) at
    bf16 storage through the new arithmetic, on JAX's draws, against JAX's
    bf16 frame: totals within 5% (floor 100), tests/test_mxu_fft.py:
    107-130's rule."""
    jcfg = jax_config.LinkConfig(
        modem=jax_config.ModemConfig(constel_size=64, n_fft=256, n_sub_carr=128),
        array=jax_config.ArrayConfig(n_elements=8),
        channel=jax_config.ChannelConfig(model="rayleigh"),
        rx=jax_config.RxConfig(algorithm="mcnc"),
        channel_storage="bfloat16", mxu_fft_storage="bfloat16")
    keys = jax.random.split(jax.random.key(14), N_FRAMES)
    n_ant, n_sc, n_bits = 8, 128, jcfg.modem.n_bits_per_ofdm_sym

    def one(key):
        k_chan, _, k_bits_c, k_bits_d, k_noise_c, k_noise_d = jax.random.split(key, 6)
        _, k_fade = jax.random.split(k_chan)
        return (jax.random.normal(k_fade, (2, n_ant, n_sc), jnp.bfloat16).astype(jnp.float32),
                jax_bits.random_payload_bits(k_bits_c, n_bits),
                jax_bits.random_payload_bits(k_bits_d, n_bits),
                jax.random.normal(k_noise_c, (2, n_sc), jnp.float32),
                jax.random.normal(k_noise_d, (2, n_sc), jnp.float32))

    with jax.enable_x64(False):
        fade, bc, bd, nc, nd = [np.asarray(a) for a in jax.jit(jax.vmap(one))(keys)]
        f = jax.jit(jax.vmap(jax_planar.make_planar_frame_fn(jcfg, N_ITERS, storage="bfloat16"),
                             in_axes=(0, None, None)))
        jc = f(keys, np.float32(SNR_DB), jax_link_static(jcfg)[0])
    pcfg = pt_config.config_from_dict(dataclasses.asdict(jcfg))
    frame = link.make_frame_fn(pcfg, N_ITERS, device="cpu")
    pc = frame(np.float32(SNR_DB), link.FrameDraws.from_numpy(fade, bc, bd, nc, nd))
    a = np.concatenate([[np.asarray(jc.clean_err).sum()],
                        np.asarray(jc.dist_err).sum(0)]).astype(float)
    b = np.concatenate([[pc.clean_err.sum()], pc.dist_err.sum(0)]).astype(float)
    assert b[1] > 0 and b[-1] <= b[1]
    assert np.all(np.abs(a - b) <= 0.05 * np.maximum(a, 100)), (a, b)
