"""The span recorder (``utils/spans.py``) and the spans at the planar,
multi-user and coded frames' stages, on the CPU: off it hands back one
shared object and keeps nothing; on it keeps the nesting, the rounds and
the counts; a CNC and an MCNC frame, the two-user frame with each of its
receivers, and the LDPC-coded frame with CNC and MCNC give the stage tree
``PERF.md`` §3 lists, with counters bit-identical on and off; spans land
on the profiler's trace clock."""

import ast
import gc
import json
import os
import tempfile
from collections import Counter

import pytest
import torch

from mimo_ofdm_tpu_torch.models import link, link_mu
from mimo_ofdm_tpu_torch.utils import config, profiling, spans

N_ITERS = 2
BATCH = 3
N_ANT = 8


@pytest.fixture(autouse=True)
def recorder_off():
    spans.disable()
    spans.collect()
    yield
    spans.disable()
    spans.collect()


def test_off_hands_back_one_shared_object_and_keeps_nothing():
    assert not spans.enabled()
    a, b = spans.span("frame", frames=4), spans.span("chain")
    assert a is spans.OFF and b is spans.OFF
    with spans.span("frame", frames=4) as inside:
        with spans.span("chain", rows=8):
            pass
    assert inside is None
    assert spans.collect() == []


def test_the_recorder_imports_neither_torch_nor_the_port():
    """So that off it can call no profiler range, NVTX range, tensor op or
    sync, and every module of the port can import it."""
    tree = ast.parse(open(spans.__file__).read())
    imported = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
    assert imported <= {"__future__", "functools", "time", "typing"}


def test_every_span_with_counts_in_the_port_asks_first():
    """A span's counts and their keyword dict are built before the call, so
    off they would cost an allocation and arithmetic: every such call site
    in the port reads ``span(...) if enabled() else OFF``."""
    root = os.path.dirname(os.path.dirname(spans.__file__))
    sites = 0
    for folder, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(folder, name)).read())
            guarded = {id(n.body) for n in ast.walk(tree) if isinstance(n, ast.IfExp)
                       and isinstance(n.test, ast.Call) and getattr(n.test.func, "id", "") == "enabled"
                       and getattr(n.orelse, "id", "") == "OFF"}
            for n in ast.walk(tree):
                if (isinstance(n, ast.Call) and getattr(n.func, "id", "") == "span"
                        and n.keywords):
                    sites += 1
                    assert id(n) in guarded, f"{name}:{n.lineno} builds counts off"
    assert sites >= 6


def test_on_keeps_nesting_parents_rounds_and_counts():
    spans.enable()
    with spans.span("setup.frame_fn"):
        pass
    for r in range(2):
        with spans.span("frame", frames=4):
            with spans.span("chain", rows=32):
                pass
            with spans.span("rx.pass", index=0):
                with spans.span("rx.detect"):
                    pass
    rec = spans.collect()
    assert [s.name for s in rec] == ["setup.frame_fn", "frame", "chain", "rx.pass",
                                     "rx.detect", "frame", "chain", "rx.pass", "rx.detect"]
    assert [s.parent for s in rec] == [-1, -1, 1, 1, 3, -1, 5, 5, 7]
    assert [s.round for s in rec] == [-1, 0, 0, 0, 0, 1, 1, 1, 1]
    assert rec[1].counts == {"frames": 4} and rec[2].counts == {"rows": 32}
    assert rec[3].counts == {"index": 0} and rec[4].counts == {}
    for s in rec:
        assert s.end_ns >= s.start_ns > 0
        if s.parent >= 0:
            p = rec[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert spans.collect() == []


def test_recording_adds_nothing_the_garbage_collector_counts():
    """The record is one flat list of strings and ints. A span kept as an
    object, or its counts as a dict, would count toward the collector's
    threshold and set off its passes inside a traced window."""
    spans.enable()
    gc.collect()
    gc.disable()
    try:
        before = gc.get_count()[0]
        for i in range(5000):
            with spans.span("frame", frames=i):
                with spans.span("chain", rows=2 * i):
                    pass
        grown = gc.get_count()[0] - before
    finally:
        gc.enable()
    assert grown < 50
    rec = spans.collect()
    assert len(rec) == 10000 and rec[-1].counts == {"rows": 2 * 4999}


def test_a_span_closes_when_its_block_raises():
    spans.enable()
    with pytest.raises(ValueError):
        with spans.span("frame"):
            raise ValueError("x")
    with spans.span("frame"):
        pass
    rec = spans.collect()
    assert [(s.name, s.parent, s.round) for s in rec] == [("frame", -1, 0), ("frame", -1, 1)]


def test_collect_refuses_an_open_span_and_enable_starts_afresh():
    spans.enable()
    with spans.span("frame"):
        with pytest.raises(RuntimeError):
            spans.collect()
    spans.enable()
    with spans.span("frame"):
        pass
    assert [s.round for s in spans.collect()] == [0]


def test_spanned_runs_the_function_inside_its_span():
    @spans.spanned("decode")
    def decode(x, *, k=1):
        with spans.span("inner"):
            return x + k

    assert decode(1, k=2) == 3 and spans.collect() == []
    spans.enable()
    assert decode(1) == 2
    assert [(s.name, s.parent) for s in spans.collect()] == [("decode", -1), ("inner", 0)]
    assert decode.__name__ == "decode"


def test_spans_land_on_the_trace_clock():
    """Under the CPU profiler, each op run inside a span lies inside the span
    put on the Chrome trace's clock (the card's test holds the kernels'
    launch calls to it)."""
    x = torch.ones(4096)
    spans.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(10):
            with spans.span("chain"):
                torch.mul(x, 3.0)
            torch.add(x, 1.0)
    rec = spans.collect()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    on_trace = spans.on_trace_clock(rec, trace["baseTimeNanoseconds"])
    muls = sorted((e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
                  if e.get("name") == "aten::mul")
    adds = sorted(e["ts"] for e in trace["traceEvents"] if e.get("name") == "aten::add")
    assert len(muls) == len(adds) == len(on_trace) == 10
    for (s, e), add, sp in zip(muls, adds, on_trace):
        assert sp.start <= s <= e <= sp.end
        assert not sp.start <= add <= sp.end


def _cfg(alg: str, model: str = "rayleigh") -> config.LinkConfig:
    return config.LinkConfig(modem=config.ModemConfig(n_fft=256, n_sub_carr=128),
                             array=config.ArrayConfig(n_elements=N_ANT),
                             channel=config.ChannelConfig(model=model),
                             rx=config.RxConfig(algorithm=alg, max_cnc_iters=N_ITERS))


def _frame_with_spans(alg: str, model: str = "rayleigh"):
    """One planar frame on fixed draws with spans off, then on: the
    counters of both and the spans of the call that was recorded."""
    cfg = _cfg(alg, model)
    spans.enable()
    frame_fn = link.make_frame_fn(cfg, N_ITERS, device="cpu")
    built = spans.collect()
    spans.disable()
    draws = frame_fn.draw(BATCH, torch.Generator().manual_seed(7))
    off = frame_fn(15.0, draws)
    spans.enable()
    on = frame_fn(15.0, draws)
    return off, on, built, spans.collect()


@pytest.mark.parametrize("alg", ["cnc", "mcnc"])
def test_planar_frame_stage_tree(alg):
    off, on, built, rec = _frame_with_spans(alg)
    assert [s.name for s in built] == ["setup.frame_fn"]
    assert torch.equal(off.clean_err, on.clean_err) and torch.equal(off.dist_err, on.dist_err)
    top = [s for s in rec if s.parent == -1]
    assert [s.name for s in top] == ["frame"] and top[0].counts == {"frames": BATCH}
    assert {s.round for s in rec} == {0}
    children = [s.name for s in rec if s.parent == 0]
    assert children[:3] == ["frame.channel", "frame.precoder", "frame.clean"]
    assert children[3:6] == ["tx.precode", "chain", "tx.combine"]     # the distorted TX
    assert children[6] == "frame.awgn" and children[-1] == "frame.count"
    passes = [i for i, s in enumerate(rec) if s.name == "rx.pass"]
    assert children[7:-1] == ["rx.pass"] * (N_ITERS + 1)
    assert [rec[i].counts["index"] for i in passes] == list(range(N_ITERS + 1))
    for i in passes:
        assert [s.name for s in rec if s.parent == i] == ["rx.detect", "rx.replica", "rx.update"]
    replicas = [i for i, s in enumerate(rec) if s.name == "rx.replica"]
    for i in replicas:
        inside = [s for s in rec if s.parent == i]
        if alg == "mcnc":        # the full planar TX again
            assert [s.name for s in inside] == ["tx.precode", "chain", "tx.combine"]
            assert inside[1].counts == {"rows": BATCH * N_ANT}
        else:                    # one PA's replica through the complex-ended chain call
            assert [s.name for s in inside] == ["chain"] and inside[0].counts == {"rows": BATCH}
    tx_chain = next(s for s in rec if s.name == "chain" and s.parent == 0)
    assert tx_chain.counts == {"rows": BATCH * N_ANT}
    counts = Counter(s.name for s in rec)
    assert counts["chain"] == 1 + N_ITERS + 1
    assert counts["tx.precode"] == (1 + N_ITERS + 1 if alg == "mcnc" else 1)


def test_los_frame_counters_equal_with_spans_on_and_off():
    off, on, _, rec = _frame_with_spans("cnc", "los")
    assert torch.equal(off.clean_err, on.clean_err) and torch.equal(off.dist_err, on.dist_err)
    assert sum(s.name == "frame" for s in rec) == 1


def _probe_kernel_calls(monkeypatch):
    """Wrap the fused chain's four entry points, planes and complex (as
    ``ops/fused_chain.py`` calls them), precoded (as the planar frame does)
    and the multi-user precoded one (as ``transmit.py`` calls it through
    ``ops/fused_chain.py``), so that each call records a ``probe`` span."""
    from mimo_ofdm_tpu_torch.models import link_planar
    from mimo_ofdm_tpu_torch.ops import fused_chain

    def probed(real):
        def probe(*a, **kw):
            with spans.span("probe"):
                return real(*a, **kw)
        return probe

    for module, name in ((fused_chain, "fused_ifft_pa_fft"),
                         (fused_chain, "fused_ifft_pa_fft_complex"),
                         (link_planar, "fused_precoded_ifft_pa_fft"),
                         (fused_chain, "fused_precoded_mu_ifft_pa_fft")):
        monkeypatch.setattr(module, name, probed(getattr(module, name)))


def test_every_kernel_call_runs_inside_a_chain_span(monkeypatch):
    """Each call of the fused chain's three entry points, planes, complex
    and precoded (the plain version here, the kernel on the card), runs with
    a ``chain`` span as the innermost one open."""
    _probe_kernel_calls(monkeypatch)
    for alg in ("mcnc", "cnc"):
        rec = _frame_with_spans(alg)[3]
        probes = [s for s in rec if s.name == "probe"]
        assert len(probes) == 1 + N_ITERS + 1
        assert all(rec[s.parent].name == "chain" for s in probes)


# the two-user frame's counters [B, U, clean + passes] on _mu_frame_with_spans'
# draws, as the frame gave them before it had spans
MU_COUNTERS_BEFORE_SPANS = {
    "cnc": [[[45, 91, 82, 90], [63, 142, 160, 177]], [[47, 107, 98, 98], [53, 143, 177, 181]],
            [[52, 76, 73, 83], [81, 149, 172, 172]]],
    "cnc_mu": [[[45, 91, 259, 283], [63, 142, 241, 252]],
               [[47, 107, 251, 274], [53, 143, 251, 272]],
               [[52, 76, 238, 262], [81, 149, 256, 272]]],
    "mcnc_mu": [[[45, 91, 78, 84], [63, 142, 107, 101]], [[47, 107, 91, 93], [53, 143, 109, 98]],
                [[52, 76, 63, 73], [81, 149, 94, 79]]],
}
N_USR = 2


def _mu_frame_with_spans(alg: str):
    """One two-user LOS frame at +-30 deg on fixed draws with spans off,
    then on: the counters ``[B, U, n_iters + 2]`` of both and the spans of
    the call that was recorded."""
    cfg = config.LinkConfig(modem=config.ModemConfig(n_fft=256, n_sub_carr=128, n_users=N_USR),
                            array=config.ArrayConfig(n_elements=N_ANT),
                            channel=config.ChannelConfig(model="los"),
                            rx=config.RxConfig(algorithm=alg, max_cnc_iters=N_ITERS))
    frame_fn = link_mu.make_mu_frame_fn(cfg, N_ITERS, link_mu.default_user_positions(),
                                        device="cpu")
    draws = frame_fn.draw(BATCH, torch.Generator().manual_seed(7))

    def counters(c):
        return torch.cat([c.clean_err[..., None], c.dist_err], -1)

    off = counters(frame_fn(15.0, draws))
    spans.enable()
    on = counters(frame_fn(15.0, draws))
    return off, on, spans.collect()


@pytest.mark.parametrize("alg", ["cnc", "cnc_mu", "mcnc_mu"])
def test_mu_frame_counters_equal_on_off_and_before_the_spans(alg):
    off, on, _ = _mu_frame_with_spans(alg)
    assert torch.equal(off, on)
    assert off.tolist() == MU_COUNTERS_BEFORE_SPANS[alg]


@pytest.mark.parametrize("alg", ["cnc", "cnc_mu", "mcnc_mu"])
def test_mu_frame_stage_tree(alg):
    """The planar frame's stages; the MCNC-MU replica's precode and combine
    in ``mu.precode``/``mu.combine``, inside ``rx.replica`` only."""
    rec = _mu_frame_with_spans(alg)[2]
    top = [s for s in rec if s.parent == -1]
    assert [s.name for s in top] == ["frame"]
    assert top[0].counts == {"frames": BATCH, "users": N_USR}
    children = [s.name for s in rec if s.parent == 0]
    assert children == ["frame.channel", "frame.precoder", "frame.clean", "tx.precode", "chain",
                        "tx.combine", "frame.awgn", *["rx.pass"] * (N_ITERS + 1), "frame.count"]
    tx_chain = next(s for s in rec if s.name == "chain" and s.parent == 0)
    assert tx_chain.counts == {"rows": BATCH * N_ANT}           # the users summed first
    passes = [i for i, s in enumerate(rec) if s.name == "rx.pass"]
    for i in passes:
        assert [s.name for s in rec if s.parent == i] == ["rx.detect", "rx.replica", "rx.update"]
    for i in (i for i, s in enumerate(rec) if s.name == "rx.replica"):
        inside = [s for s in rec if s.parent == i]
        if alg == "mcnc_mu":     # the whole two-user TX, each user's detection swapped in
            assert [s.name for s in inside] == ["mu.precode", "chain", "mu.combine"]
            assert inside[1].counts == {"rows": BATCH * N_USR * N_ANT}
        else:                    # one PA's replica a user
            assert [s.name for s in inside] == ["chain"]
            assert inside[0].counts == {"rows": BATCH * N_USR}
    counts = Counter(s.name for s in rec)
    assert counts["chain"] == 1 + N_ITERS + 1
    mu = N_ITERS + 1 if alg == "mcnc_mu" else 0
    assert counts["mu.precode"] == counts["mu.combine"] == mu
    assert all(rec[s.parent].name == "rx.replica" for s in rec if s.name.startswith("mu."))


def test_every_kernel_call_of_the_mu_frame_runs_inside_a_chain_span(monkeypatch):
    """The two-user frame's chain calls (the TX and every replica; the
    multi-user precoded entry point, or the complex one for the CNC
    replicas) each run with a ``chain`` span as the innermost one open."""
    _probe_kernel_calls(monkeypatch)
    for alg in ("mcnc_mu", "cnc"):
        rec = _mu_frame_with_spans(alg)[2]
        probes = [s for s in rec if s.name == "probe"]
        assert len(probes) == 1 + N_ITERS + 1
        assert all(rec[s.parent].name == "chain" for s in probes)


def test_profiling_recording_restores_the_recorder():
    with profiling.recording() as rec:
        with spans.span("decode"):
            pass
    assert [s.name for s in rec] == ["decode"] and not spans.enabled()
    spans.enable()
    with profiling.recording() as rec:
        pass
    assert spans.enabled()


LDPC_ITERS = 3


def _coded_frame_with_spans(alg: str):
    """The coded link's transport frame (``ldpc_ref_ber``'s: the
    reference's transport sizing, sum-product) at n_fft 256 on LOS, fixed
    draws, spans off, then on: the counters of both, the spans of building
    it and those of the call that was recorded."""
    from mimo_ofdm_tpu_torch.experiments.ber_sweeps import coded_link_config
    from mimo_ofdm_tpu_torch.models import link_ldpc

    cfg = coded_link_config("los", alg, N_ANT, 0.0, small=True)
    chain = link_ldpc.reference_chain(cfg, 0.5)
    spans.enable()
    frame_fn = link_ldpc.make_transport_frame_fn(cfg, N_ITERS, chain, LDPC_ITERS,
                                                 ldpc_algorithm="sumprod", device="cpu")
    built = spans.collect()
    spans.disable()
    draws = link.FrameDraws.draw(cfg, BATCH, torch.Generator().manual_seed(7), n_bits=chain.a)
    off = frame_fn(10.0, draws)
    spans.enable()
    on = frame_fn(10.0, draws)
    return off, on, built, spans.collect()


@pytest.mark.parametrize("alg", ["cnc", "mcnc"])
def test_coded_frame_counters_equal_with_spans_on_and_off(alg):
    off, on, _, _ = _coded_frame_with_spans(alg)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.mark.parametrize("alg", ["cnc", "mcnc"])
def test_coded_frame_stage_tree(alg):
    """The planar frame's stages around the coded receiver: the passes, the
    demapper of the passes and of the clean run, one decode of every
    (frame, pass) codeword, the count."""
    _, _, built, rec = _coded_frame_with_spans(alg)
    assert [s.name for s in built] == ["setup.frame_fn"]
    top = [s for s in rec if s.parent == -1]
    assert [s.name for s in top] == ["frame"] and top[0].counts == {"frames": BATCH}
    assert {s.round for s in rec} == {0}
    children = [s.name for s in rec if s.parent == 0]
    assert children == ["frame.channel", "frame.precoder", "frame.clean", "chain", "frame.awgn",
                        *["rx.pass"] * (N_ITERS + 1), "soft_demap", "soft_demap", "decode",
                        "frame.count"]
    tx_chain = next(s for s in rec if s.name == "chain" and s.parent == 0)
    assert tx_chain.counts == {"rows": BATCH * N_ANT}
    for i in (i for i, s in enumerate(rec) if s.name == "rx.pass"):
        assert [s.name for s in rec if s.parent == i] == ["rx.detect", "rx.replica", "rx.update"]


def test_the_coded_decode_span_counts_codewords_and_iterations_once():
    """``ops/ldpc.py::decode``'s span counts the codewords it decodes and
    their iterations; the transport decode around it counts nothing, so no
    codeword is counted twice."""
    _, _, _, rec = _coded_frame_with_spans("cnc")
    decodes = [(i, s) for i, s in enumerate(rec) if s.name == "decode"]
    assert len(decodes) == 2
    (outer_i, outer), (_, inner) = decodes
    assert outer.parent == 0 and outer.counts == {}
    assert inner.parent == outer_i
    assert inner.counts == {"codewords": BATCH * (N_ITERS + 2), "iters": LDPC_ITERS}
