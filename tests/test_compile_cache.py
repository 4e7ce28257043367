"""The compile cache lives in one place: the environment's directory, else
``.jax_cache`` at the root of the checkout, wherever the process runs.
Also the device helpers every measurement uses (gemini_seal.devices)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from gemini_seal import compile_cache

REPO = Path(__file__).resolve().parent.parent


def test_env_dir_wins_and_is_left_to_jax(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)
    assert compile_cache.enable() == str(tmp_path)
    # JAX reads the variable itself; the helper sets no other directory
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_inside_the_checkout():
    path = Path(compile_cache.cache_dir({}))
    assert path == REPO / ".jax_cache"


def test_default_does_not_depend_on_cwd(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c",
         "from gemini_seal import compile_cache; "
         "print(compile_cache.cache_dir())"],
        cwd=tmp_path, env=env, check=True, capture_output=True, text=True,
    )
    assert out.stdout.strip() == str(REPO / ".jax_cache")


def test_require_gpu_refuses_other_backends():
    from gemini_seal.devices import require_gpu

    require_gpu("gpu")
    with pytest.raises(SystemExit):
        require_gpu("cpu")


def test_time_calls_waits_for_the_real_output():
    import jax.numpy as jnp

    from gemini_seal.devices import device_record, time_calls

    calls = []

    def step(x):
        calls.append(1)
        return x * 2

    per = time_calls(step, (jnp.arange(8),), min_seconds=0.01, max_iters=5)
    assert per > 0 and 5 <= len(calls) <= 7
    assert device_record(jax.devices()[:1])["count"] == 1
