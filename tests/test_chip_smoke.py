"""chip_smoke.py off the card: options, refusal without a GPU, tolerance
helpers, and each phase rehearsed at a tiny size on the CPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import chip_smoke as cs  # noqa: E402

TINY = {"spec1": "synth:2000:24000", "spec4": "synth:4000:48000",
        "poisson_edge": 8}


def test_default_runs_phases_0_to_3():
    args = cs.parse_args([])
    assert not args.four_cards
    assert cs.phases_for(args) == ["device", "cli-spmv", "solve",
                                   "spmm-grad"]
    assert [cs.PHASES[p][0] for p in cs.phases_for(args)] == [0, 1, 2, 3]


def test_four_cards_runs_only_phase_4():
    args = cs.parse_args(["--four-cards"])
    assert args.four_cards
    assert cs.phases_for(args) == ["four-cards"]


def test_unknown_option_is_a_usage_error():
    with pytest.raises(SystemExit) as e:
        cs.parse_args(["--cards", "2"])
    assert e.value.code == 2


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_refuses_cpu_without_result(argv, capsys):
    assert cs.main(argv) != 0
    out = capsys.readouterr()
    assert out.out.strip() == ""
    assert "no GPU" in out.err


def test_alone_in_a_directory_fails(tmp_path):
    """Without the rest of the repository the script cannot pass."""
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("got,ref,expected", [
    ([1.0, 2.0], [1.0, 2.0], 0.0),
    ([1.0, 2.5], [1.0, 2.0], 0.25),
    ([0.0, 4.0], [1.0, 4.0], 0.25),
])
def test_rel_max_err(got, ref, expected):
    assert cs.rel_max_err(got, ref) == pytest.approx(expected)


def test_rel_max_err_nonfinite_and_shape():
    assert np.isnan(cs.rel_max_err([np.nan, 1.0], [1.0, 1.0]))
    with pytest.raises(cs.PhaseError):
        cs.rel_max_err([1.0], [1.0, 2.0])


def test_check_passes_and_fails():
    assert "<=" in cs.check("err", 1e-6, cs.SPMV_TOL)
    with pytest.raises(cs.PhaseError, match="exceeds"):
        cs.check("err", 2e-5, cs.SPMV_TOL)
    with pytest.raises(cs.PhaseError):
        cs.check("err", float("nan"), cs.SPMV_TOL)


def test_check_cg_bounds():
    cs.check_cg(1.05e-3, 1.0e-3)             # 5 % apart
    cs.check_cg(2e-6, 1e-12)                 # both at f32's floor
    with pytest.raises(cs.PhaseError):
        cs.check_cg(1.5e-3, 1.0e-3)          # 50 % apart
    with pytest.raises(cs.PhaseError):
        cs.check_cg(float("nan"), 1.0e-3)


def test_report_vector_parses_cli_report(tmp_path):
    from smvp_toolkit_tpu.bench.harness import TimingStats
    from smvp_toolkit_tpu.bench.report import write_report

    y = np.array([1.5, -2.25, 3e-7])
    write_report(str(tmp_path), alg_name="CSR", input_file="m.mtx", nnz=3,
                 iterations=1, stats=TimingStats(np.ones(1), 1),
                 output_vector=y)
    np.testing.assert_allclose(cs._report_vector(str(tmp_path), "CSR"), y)
    with pytest.raises(cs.PhaseError):
        cs._report_vector(str(tmp_path), "TJDS")


def test_poisson3d_is_the_7_point_operator():
    a = cs.poisson3d(4)
    assert a.shape == (64, 64)
    assert a.nnz == 7 * 64 - 6 * 16
    assert np.allclose(a.diagonal(), 6.0)
    assert abs(a - a.T).max() == 0


@pytest.mark.parametrize("phase", ["cli-spmv", "solve", "spmm-grad",
                                   "four-cards"])
def test_phase_rehearsal_on_cpu(phase, capsys):
    """Each phase runs end to end at a tiny size and meets its
    tolerance (the card run is the same code at full size)."""
    assert cs.run_phases([phase], dict(TINY))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"phase {cs.PHASES[phase][0]} {phase}: ok")


def test_failed_phase_fails_the_run(capsys):
    def boom(ctx):
        raise cs.PhaseError("err 1e-3 exceeds 1e-05")

    cs.PHASES["boom"] = (9, boom)
    try:
        assert not cs.run_phases(["boom"], {})
    finally:
        del cs.PHASES["boom"]
    assert "FAILED" in capsys.readouterr().out


def test_result_line_shape(monkeypatch, capsys):
    """With a GPU present and every phase passing, the last line is the
    result object with the device as JAX reports it."""
    import smvp_toolkit_tpu.bench.device as dev

    monkeypatch.setattr(dev, "require_gpu", lambda: None)
    monkeypatch.setattr(dev, "nvidia_smi_name_power",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(cs, "run_phases", lambda names, ctx: True)
    assert cs.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "nvidia-smi: NVIDIA H100 80GB HBM3, 700.00 W"
    last = lines[-1]
    rec = json.loads(last)
    assert rec["ok"] is True
    assert set(rec["device"]) == {"platform", "kind", "count"}


@pytest.mark.gpu
def test_cusparse_route_is_the_library_kernel_on_card(gpu):
    """On the card the cuSPARSE route lowers to cuSPARSE itself: JAX's
    generic-lowering warning would be an error here."""
    import warnings

    import jax
    import jax.numpy as jnp
    from jax.experimental.sparse import CuSparseEfficiencyWarning

    from smvp_toolkit_tpu.formats.csr import csr_encode
    from smvp_toolkit_tpu.ops import spmv_csr_cusparse
    from smvp_toolkit_tpu.utils.synth import synth_banded

    csr = csr_encode(synth_banded(4096, nnz_per_row=8, seed=0).pad(128))
    x = jnp.ones((4096,), jnp.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error", CuSparseEfficiencyWarning)
        hlo = jax.jit(spmv_csr_cusparse).lower(csr, x).as_text()
    assert "cusparse" in hlo.lower()


@pytest.mark.gpu
def test_card_has_a_peak_entry(gpu):
    from smvp_toolkit_tpu.bench.roofline import hbm_bandwidth_gbs

    assert hbm_bandwidth_gbs(gpu) > 0
