"""chip_smoke.py's phases at tiny sizes on the CPU, its refusal to run
without a GPU, and the compile-cache helper it shares with bench.py."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_main_exits_nonzero_without_gpu(capsys):
    assert chip_smoke.main([]) == 2
    assert chip_smoke.main(["--chips", "4"]) == 2
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_script_alone_fails(tmp_path):
    """Copied out of the checkout it cannot import the package: it exits
    non-zero and prints no result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_device_reports_backend(tmp_path, monkeypatch):
    # with the env var set the helper configures nothing in this process
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    info = chip_smoke.phase_device(require_gpu_tools=False)
    assert info["platform"] == "cpu" and info["count"] == len(jax.devices())
    assert info["compile_cache"] == str(tmp_path)


def test_phase_precision():
    assert chip_smoke.phase_precision(B=2, m=16)["max_rel_err"] <= 1e-5


@pytest.fixture(scope="module")
def main_path():
    return chip_smoke.phase_main_path(B=8, m=16, highs_lanes=4)


def test_phase_main_path(main_path):
    assert main_path["optimal"] == 8 and main_path["certified"] >= 7
    assert main_path["highs_gap"] <= 1e-5


def test_phase_double_word(main_path):
    c, G, h, res = main_path["_data"]
    out = chip_smoke.phase_double_word(c, G, h, res.basis, lanes=8)
    assert out["swapped_certified"] == 0
    diffs = out["max_abs_diff"]
    assert max(diffs["primal_residual"], diffs["min_xB"],
               diffs["min_reduced_cost"]) <= 1e-6
    assert diffs["gap"] <= 1e-5


@pytest.mark.parametrize("site,shape", [
    ("two_phase_m256", (4, 12, 2)), ("two_phase_m1024", (2, 20, 1)),
    ("bounded_m256", (4, 10, 2)), ("warm_rhs_m256", (4, 12, 2)),
    ("exact_repair_m256", (8, 16, 2)), ("ipm_m1024", (4, 16, 2)),
])
def test_phase_sites(site, shape):
    assert site in chip_smoke.SITES
    out = chip_smoke.phase_sites({site: shape})[site]
    assert out["optimal"] >= shape[0] / 2 and out["first_call_s"] > 0


@pytest.mark.parametrize("early_refs", [False, True])
def test_phase_families(early_refs):
    sizes = dict(sparse_m=40, sparse_lanes=4, density=0.2)
    refs = (chip_smoke.submit_sparse_references(chip_smoke._Inline(),
                                                highs_lanes=2, **sizes)
            if early_refs else None)
    out = chip_smoke.phase_families(pdhg_n=32, sparse_refs=refs, **sizes)
    assert out["pdhg_kkt"]["duality_gap"] <= 1e-3
    assert out["sparse_gap"] <= 1e-2


def test_sites_reuse_compiled_shapes():
    """The warm-RHS base solve is the two-phase site's solve and the exact
    repair runs at phase 2's shape, so neither compiles anew on the card."""
    import inspect

    main = inspect.signature(chip_smoke.phase_main_path).parameters
    sites = chip_smoke.SITES
    assert sites["exact_repair_m256"][:2] == (main["B"].default,
                                              main["m"].default)
    assert sites["warm_rhs_m256"][:2] == sites["two_phase_m256"][:2]


def test_highs_pool_runs_in_worker_processes():
    """main() hands HiGHS to spawned workers: the job must pickle and run
    there without JAX."""
    import concurrent.futures
    import multiprocessing

    import numpy as np

    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        status, fun = pool.submit(
            chip_smoke._highs, np.array([-1.0, -1.0]),
            A_ub=np.array([[1.0, 2.0], [3.0, 1.0]]),
            b_ub=np.array([4.0, 6.0])).result(timeout=120)
    assert status == 0 and abs(fun + 2.8) < 1e-9


def test_phase_sharded_on_virtual_devices():
    out = chip_smoke.phase_sharded(n_dev=4, B=8, m=12)
    assert out["exact"]["max_rel_cost_diff"] <= 1e-5
    assert out["two_phase"]["cost_devices"] == 4


def _cache_dir_in_subprocess(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    code = ("import jax; from linprog_tpu.compile_cache import "
            "enable_compile_cache; p = enable_compile_cache(); "
            "print(p); print(jax.config.jax_compilation_cache_dir)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300,
                          check=True)
    return proc.stdout.split()[-2:]


def test_compile_cache_honours_env_var(tmp_path):
    returned, configured = _cache_dir_in_subprocess(tmp_path / "cc")
    assert returned == configured == str(tmp_path / "cc")


def test_compile_cache_defaults_to_checkout():
    returned, configured = _cache_dir_in_subprocess(None)
    assert returned == configured == str(REPO / ".jax_cache")
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_dryrun_multichip_refuses_short_gpu_host(monkeypatch):
    """On a GPU host with too few cards the dry run raises instead of
    quietly switching to a virtual CPU mesh."""
    import __graft_entry__

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "devices", lambda *a: [object()])
    with pytest.raises(RuntimeError, match="needs 4 gpu devices"):
        __graft_entry__.dryrun_multichip(4)


def test_run_concurrently_runs_every_job_then_raises():
    ran = []

    def ok():
        ran.append("ok")
        return 1

    def bad():
        ran.append("bad")
        raise ValueError("boom")

    with pytest.raises(AssertionError, match="bad"):
        chip_smoke._run_concurrently({"ok": ok, "bad": bad})
    assert sorted(ran) == ["bad", "ok"]
    assert chip_smoke._run_concurrently({"a": lambda: 2}) == {"a": 2}
