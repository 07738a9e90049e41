"""chip_smoke.py and bench.py off the card: both refuse to run without a GPU,
the result line carries exactly the contract's keys, every phase runs at a
tiny size when called directly on the CPU, and a failing phase fails the
script."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
import chip_smoke  # noqa: E402


class FakeDevice:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"

    def memory_stats(self):
        return {"peak_bytes_in_use": 1}


def _run(script, cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script), *args], cwd=str(cwd),
                          env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_exits_nonzero_without_gpu(script):
    r = _run(REPO / script, REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_has_exactly_the_contract_keys(count):
    line = chip_smoke.result_line([FakeDevice()] * count)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}
    assert "\n" not in line


def _fake_gpu(monkeypatch, phases):
    import jax

    monkeypatch.setattr(jax, "devices", lambda *a, **k: [FakeDevice()])
    monkeypatch.setattr(chip_smoke, "card_identity", lambda: "NVIDIA H100, 700.00 W")
    monkeypatch.setattr(chip_smoke, "PHASES", phases)
    from multigridmc_tpu.utils import runtime

    monkeypatch.setattr(runtime, "configure_runtime", lambda **kw: None)


def test_failing_phase_fails_the_script(monkeypatch, capsys):
    def broken():
        chip_smoke.check("broken", 2.0, 1.0)

    _fake_gpu(monkeypatch, {1: ("broken", broken)})
    with pytest.raises(AssertionError, match="exceeds"):
        chip_smoke.main(["--phases", "1"])
    out = capsys.readouterr().out
    assert '"ok": true' not in out
    assert "== phase broken FAILED" in out


def test_passing_phases_end_with_the_result_line(monkeypatch, capsys):
    ran = []
    _fake_gpu(monkeypatch, {1: ("a", lambda: ran.append(1)),
                            2: ("b", lambda: ran.append(2))})
    assert chip_smoke.main(["--phases", "2,1"]) == 0
    assert ran == [2, 1]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["device"]["count"] == 1


def test_moment_gate_accepts_exact_and_rejects_biased_samples():
    rng = np.random.default_rng(0)
    z = rng.normal(1.0, 2.0, size=(400, 64))
    stats = chip_smoke.moment_gate("iid", z, 1.0, 4.0)
    assert 0.8 < stats["tau"] < 1.2
    with pytest.raises(AssertionError, match="mean"):
        chip_smoke.moment_gate("biased", z + 0.2, 1.0, 4.0)


# ------------------------------------------- phases at a tiny size on the CPU
def test_phase_drivers_tiny(tmp_path):
    cfg = (REPO / "tests" / "fixtures" / "flagship.cfg").read_text()
    for a, b in (("nx = 256;", "nx = 16;"), ("ny = 256;", "ny = 16;"),
                 ("nlevel = 5;", "nlevel = 3;"), ("nsamples = 200;", "nsamples = 20;"),
                 ("nwarmup = 200;", "nwarmup = 20;")):
        cfg = cfg.replace(a, b)
    (tmp_path / "tiny.cfg").write_text(cfg)
    shutil.copy(REPO / "tests" / "fixtures" / "flagship_measurements.cfg", tmp_path)
    chip_smoke.phase_drivers(tmp_path / "tiny.cfg", tmp_path)
    assert (tmp_path / "timeseries_multigridmc.txt").exists()


def test_phase_moments_tiny():
    out = chip_smoke.phase_moments(nx=16, nlevel=3, nchains=16, nwarm=20,
                                   ncollect=100, block=20, ncholesky=20)
    assert set(out) == {"mgmc", "cholesky"}


def test_phase_numerics_tiny():
    rel = chip_smoke.phase_numerics(nx=16, nlevel=3, n3d=8, nlevel_3d=2, nrhs=2)
    assert rel["2d"] < 1e-12 and rel["3d"] < 1e-12  # float64 on the CPU


def test_phase_size_tiny():
    chip_smoke.phase_size(nx=16, nlevel=3, n3d=8, nlevel_3d=2, nchains=4, nsteps=2)


def test_phase_four_tiny():
    """The four-device paths on four of the CPU's virtual devices."""
    chip_smoke.phase_four(nx_sharded=32, nlevel_sharded=2, sharded_chains=8,
                          nx_dp=16, nlevel_dp=3, nchains=16, nwarm=20,
                          ncollect=100, sharded_ncollect=100, block=20)


def test_bench_measurements_tiny(monkeypatch):
    """bench.py's device measurements (throughput, A/B in turns) at a tiny
    size on the CPU: the code paths, not the numbers."""
    monkeypatch.setattr(bench, "NX", 16)
    monkeypatch.setattr(bench, "NLEVEL", 3)
    monkeypatch.setattr(bench, "NCHAINS", 4)
    out = bench.measure_device(ab=True, trace_dir=None)
    assert out["batched_samples_per_sec"] > 0
    assert set(out["subtree_ms_per_step"]) >= {"distilled", "composed"}
    assert set(out["band_ms_per_step"]["4 chains"]) >= {"doubling", "scan"}


def test_bench_hlo_scopes():
    text = ('  %fusion.3 = f32[4]{0} fusion(%p), kind=kLoop, calls=%c, '
            'metadata={op_name="jit(loop)/while/body/L0_descend/mul" stack_frame_id=1}\n'
            '  ROOT %dot.7 = f32[4]{0} dot(%a, %b), '
            'metadata={op_name="jit(loop)/while/body/distilled/dot_general"}\n'
            '  %add.1 = f32[4]{0} add(%a, %b), metadata={op_name="jit(loop)/add"}\n')
    scopes = bench.hlo_scopes(text)
    assert scopes["fusion.3"] == scopes["fusion_3"] == "L0_descend"
    assert scopes["dot.7"] == "distilled"
    assert "add.1" not in scopes


class _Event:
    def __init__(self, name, start_ns, duration_ns, hlo_op):
        self.name, self.start_ns, self.duration_ns = name, start_ns, duration_ns
        self.stats = [("hlo_op", hlo_op), ("hlo_module", "jit_loop")]


class _Line:
    def __init__(self, events):
        self.events = events


class _Plane:
    def __init__(self, name, lines):
        self.name, self.lines = name, lines


@pytest.mark.parametrize("nsteps,by_order", [(2, True), (3, False)])
def test_bench_scope_times_reports_unattributed_time(tmp_path, monkeypatch,
                                                     nsteps, by_order):
    """The trace reducer attributes kernels through their HLO instruction,
    GEMM kernels of a CUDA graph by their order when their count matches the
    HLO's, and says when too much device time has no scope."""
    import jax

    hlo = ('  %fusion.3 = f32[4]{0} fusion(%p), kind=kLoop, calls=%c, '
           'metadata={op_name="jit(loop)/while/body/L0_descend/mul"}\n'
           '  %custom-call.2 = (f32[4,4]{1,0}, s8[8]{0}) custom-call(%a, %b), '
           'custom_call_target="__cublas$gemm", '
           'metadata={op_name="jit(loop)/while/body/distilled/dot_general"}\n'
           '  %copy.1 = f32[4]{0} copy(%a), metadata={op_name="jit(loop)/while/body/copy"}\n')
    events, t = [], 0
    for _ in range(2):  # two steps
        for name, dur, op in (("fusion_3", 10, "fusion.3"),
                              ("sm90_xmma_gemm_f32f32", 30, "command_buffer"),
                              ("copy_kernel", 60, "copy.1")):
            events.append(_Event(name, t, dur, op))
            t += dur + 5
    planes = [_Plane("/host:CPU", [_Line([_Event("host", 0, 10**6, "")])]),
              _Plane("/device:GPU:0", [_Line(events)])]

    class FakeProfileData:
        @staticmethod
        def from_file(path):
            assert path.endswith(".xplane.pb")
            return type("Data", (), {"planes": planes})()

    (tmp_path / "t.xplane.pb").write_bytes(b"")
    monkeypatch.setattr(jax.profiler, "ProfileData", FakeProfileData)
    out = bench.scope_times(str(tmp_path), hlo, nsteps)
    if by_order:
        assert out["scope_ns"] == {"L0_descend": 20.0, "distilled": 60.0, "other": 120.0}
        assert out["unattributed_share"] == pytest.approx(0.6)
    else:
        assert out["scope_ns"] == {"L0_descend": 20.0, "other": 180.0}
        assert out["unattributed_share"] == pytest.approx(0.9)
    assert out["busy_ns"] == 200.0 and out["window_ns"] == t - 5
    assert out["attribution_complete"] is False
    assert out["gemm"] == {"hlo_instructions": 1, "trace_kernels_per_step": 2 / nsteps,
                           "trace_ns": 60.0, "by_order": by_order}
    assert list(out["top_other_ns"])[0] == "copy_kernel | copy.1 | jit(loop)/while/body/copy"
