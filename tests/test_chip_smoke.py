"""chip_smoke.py's phases rehearsed at tiny shapes on the CPU.

The script itself refuses to run without a GPU; these tests call each
phase function directly ("GPU vs CPU device" comparisons as CPU vs CPU,
the MPPI kernel under the Pallas interpreter through the ``interpret``
fixture), so a broken path, argument or tolerance check shows here before
it costs a chip run.
"""

import os
import shutil
import subprocess
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from tpunav.ops import pallas_mppi  # noqa: E402


@pytest.fixture
def interpret(monkeypatch):
    """Every kernel call in the test runs under the Pallas interpreter."""
    compiled = pallas_mppi._partials
    monkeypatch.setattr(
        pallas_mppi, "_partials",
        lambda *a, **kw: compiled(*a, **{**kw, "interpret": True}))


def test_mppi_kernel_phase(interpret):
    cs.phase_mppi_kernel(ks=(64, 200), obstacle_k=64)


def test_mppi_course_phase(interpret):
    cs.phase_mppi_course(k=64)


def test_mppi_course_phase_fails_when_budget_is_short(interpret):
    with pytest.raises(AssertionError):
        cs.phase_mppi_course(k=64, max_ticks=50)


def test_ekf_phase():
    cs.phase_ekf(updates=40)


def test_slam_loop_phase(interpret):
    cs.phase_slam_loop(k=64, ticks=60)


def test_rbpf_phase():
    cs.phase_rbpf(p=8, scans=6, k_samples=10, icp_iters=10)


def test_four_cards_phase_on_four_cpu_devices(interpret):
    cs.phase_four_cards(k=512, p=8, scans=2, k_samples=10,
                        devices=jax.devices()[:4])


def test_check_raises_past_tolerance(capsys):
    cs.check("x", "within", 1e-5, 1e-4)
    with pytest.raises(AssertionError):
        cs.check("x", "beyond", 2e-4, 1e-4)
    with pytest.raises(AssertionError):
        cs.check("x", "nan", float("nan"), 1e-4)
    assert "worst error" in capsys.readouterr().out


def test_main_refuses_cpu_and_prints_no_result(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repo, the script exits non-zero and prints no result."""
    shutil.copy(cs.__file__, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
