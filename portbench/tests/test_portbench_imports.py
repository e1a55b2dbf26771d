"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port. Module names are compared by their
whole top-level name: the port, ``mimo_ofdm_tpu_torch``, begins with the
JAX package's name, ``mimo_ofdm_tpu``, and is allowed."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

from portbench import run

REPO = Path(__file__).resolve().parents[2]
TESTS = Path(__file__).resolve().parent


def _top_level_modules_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{REPO}:{TESTS}",
                              "HOME": str(REPO)})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_the_harness_loads_neither_jax_nor_the_jax_package(tmp_path):
    mods = _top_level_modules_after(f"""
        import json, sys
        import portbench_tiny
        from portbench import run
        portbench_tiny.shrink()
        bench, root = portbench_tiny.make({str(tmp_path)!r})
        res = run.run(portbench_tiny.CELL, 7, 1.0, False, device="cpu",
                      benchmark=bench, root=root)
        assert res["attempted"] > 0
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    assert "mimo_ofdm_tpu_torch" in mods and "portbench" in mods
    assert not mods & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level_modules_after("""
        import json, sys, torch
        from portbench import traffic
        from portbench.reference import miso
        link = json.load(open("portbench/configs/miso_los.json"))["link"]
        link["modem"].update(n_fft=256, n_sub_carr=128)
        link["array"]["n_elements"] = 4
        d = traffic.draw_round(link, 2, 5, 0, "cpu")
        assert miso.frame_counters(link, "mcnc", 2, 15.0, d).shape == (2, 4)
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    assert "torch" in mods
    assert not mods & {*run.FORBIDDEN, "mimo_ofdm_tpu_torch"}


def test_forbidden_names_are_matched_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mimo_ofdm_tpu_torch_fake_probe", sys)
    assert run.forbidden_modules() == [m for m in run.forbidden_modules()
                                       if m in run.FORBIDDEN]
    assert "mimo_ofdm_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mimo_ofdm_tpu.utils", sys)
    assert "mimo_ofdm_tpu" in run.forbidden_modules()
