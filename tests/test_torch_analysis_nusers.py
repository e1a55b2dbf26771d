"""The port's SDR vs IBO vs user count scan
(``analysis.make_mu_nusers_sdr_fn``) held against the JAX package's on the
CPU, on JAX's own draws (tests/torch_parity_draws.py: the bits, fades and
user-angle uniforms), at n_fft 256, n_sc 128, 8 antennas, two IBO values
and 5 snapshots; and the user-angle spacing.

Tolerances (see tests/test_torch_analysis.py), each about 3x the gap
measured on these inputs. Rayleigh: float32 rounding, SDRs within 1.9e-6
dB (asserted 2e-5 dB). LOS, where the compiled JAX scan folds the constant
factors of the ~2e4 rad phase: SDRs within 2.1e-4 dB with one user
(asserted 7e-4 dB) and 1.6e-3 dB with three (asserted 5e-3 dB).
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

import torch_parity_draws as pdr
from mimo_ofdm_tpu.models import analysis as jan
from mimo_ofdm_tpu.utils import config as jcfg_mod

from mimo_ofdm_tpu_torch.models import analysis
from mimo_ofdm_tpu_torch.utils import config as pcfg_mod

N_BITS = 6 * 128
KEY = 3


def _cfgs(chan, n_ant=8, ibo=0.0):
    j = jcfg_mod.LinkConfig(
        modem=jcfg_mod.ModemConfig(constel_size=64, n_fft=256, n_sub_carr=128, cp_len=16),
        array=jcfg_mod.ArrayConfig(n_elements=n_ant),
        channel=jcfg_mod.ChannelConfig(model=chan),
        pa=jcfg_mod.PaConfig(model="softlim", ibo_db=ibo))
    return j, pcfg_mod.config_from_dict(dataclasses.asdict(j))


NUSERS_TOL = {("los", 1): 7e-4, ("los", 3): 5e-3, ("rayleigh", 3): 2e-5}


@pytest.mark.parametrize("chan,n_users", sorted(NUSERS_TOL))
def test_mu_nusers_sdr_matches_jax(chan, n_users):
    """Fresh user angles per snapshot from JAX's uniforms (the sequential
    spacing of main_multiuser_sdr_vs_ibo_vs_n_users.py:84-104)."""
    j, p = _cfgs(chan)
    key = jax.random.key(KEY)
    kw = dict(n_snapshots=5, snap_chunk=2)
    ibo = np.asarray([0.0, 3.0], np.float32)
    with jax.enable_x64(False):
        js = np.asarray(jan.make_mu_nusers_sdr_fn(j, n_users, **kw)(key, ibo))
        draws = pdr.scan_nusers(key, 2, 5, n_users, N_BITS, (8, 128))
        draws = pdr.as_torch(draws if chan == "rayleigh" else draws._replace(fade=None))
    ps = analysis.make_mu_nusers_sdr_fn(p, n_users, device="cpu", **kw)(ibo, draws)
    assert ps.shape == (2, n_users)
    np.testing.assert_allclose(ps, js, atol=NUSERS_TOL[chan, n_users])
    assert np.all(ps[0] < ps[1])


def test_user_angles_keep_their_slots():
    """draw_user_angles: each user inside its slot, at least one slot width
    from the previous user, and the JAX scaling at the interval ends."""
    u = torch.tensor([[0.0, 0.0, 0.0], [0.999999, 0.999999, 0.999999], [0.5, 0.2, 0.7]])
    a = analysis.draw_user_angles(u, 3, 10.0).numpy()
    slot = 160.0 / 3
    assert np.all(np.diff(a, axis=-1) >= slot - 1e-4)
    assert np.all(a >= 10.0) and np.all(a <= 170.0 + 1e-4)
    np.testing.assert_allclose(a[0], [10.0, 10.0 + slot, 10.0 + 2 * slot], rtol=1e-6)
    one = analysis.draw_user_angles(torch.tensor([[0.25]]), 1, 10.0)
    assert float(one) == pytest.approx(10.0 + 0.25 * 160.0)
