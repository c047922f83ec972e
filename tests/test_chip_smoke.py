"""``chip_smoke.py`` (the GPU smoke run) and the compile-cache helper the
entry scripts share.  The phases themselves need a GPU; these tests pin
what the driver relies on: refusal off the GPU, the contract line, failure
propagation and the phase selection."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

import chip_smoke

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_contract_line_has_exactly_the_contract_keys():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = json.loads(chip_smoke.contract_line([Dev()]))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_failing_phase_stops_the_run_nonzero(capsys):
    ran = []

    def good(ctx):
        ran.append("good")

    def bad(ctx):
        chip_smoke.check(False, "bound broken")

    def after(ctx):
        ran.append("after")

    ctx = chip_smoke.Context(card="test card", devices=[], peaks=None)
    assert chip_smoke.run_phases([good, bad, after], ctx) == 1
    assert ran == ["good"]
    out = capsys.readouterr().out
    assert "FAIL bad: SmokeFailure: bound broken" in out
    assert '"ok"' not in out
    assert chip_smoke.run_phases([good], ctx) == 0


@pytest.mark.parametrize("chips, names", [
    (1, ["flagship", "uniform_and_crossfade", "farm", "timings"]),
    (4, ["farm_dp4", "two_stage_sp4"]),
    (2, None),
])
def test_select_phases(chips, names):
    if names is None:
        with pytest.raises(ValueError):
            chip_smoke.select_phases(chips)
    else:
        assert [p.__name__ for p in chip_smoke.select_phases(chips)] == names


def test_compile_cache_honours_env(monkeypatch):
    import jax

    from fft_convolution_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before  # set nothing


def test_compile_cache_falls_back_to_fixed_checkout_path(monkeypatch):
    import jax

    from fft_convolution_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert compile_cache.enable_compile_cache() == path  # no pid/time
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
