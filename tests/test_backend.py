"""The per-backend policy module (``core/backend.py``): choices per
platform, the compile cache directory, the GPU requirement, and that no
code path picks a kernel, Pallas's interpret mode or a TPU branch."""

import os
import re

import jax
import pytest

from icee_tpu.core import backend

PKG = os.path.join(os.path.dirname(os.path.dirname(__file__)), "icee_tpu")


@pytest.mark.parametrize("plat", [backend.GPU, backend.CPU])
@pytest.mark.parametrize("flag", [None, True, False])
def test_chunked_ce_choice(plat, flag):
    got = backend.resolve_chunked_ce(flag, plat)
    want = backend.CHUNKED_CE_DEFAULT[plat] if flag is None else flag
    assert got is want


def test_chunked_ce_defaults_per_platform():
    # the GPU default is the faster side of the on-card A/B; the CPU keeps
    # the materialized loss its test baselines were taken with
    assert backend.CHUNKED_CE_DEFAULT == {"gpu": True, "cpu": False}
    assert backend.resolve_chunked_ce(None, "rocm") is False


def test_compile_cache_dir_follows_the_environment(tmp_path):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cache")}
    assert backend.compile_cache_dir(env) == str(tmp_path / "cache")


def test_compile_cache_dir_defaults_into_the_checkout():
    path = backend.compile_cache_dir({})
    root = os.path.dirname(PKG)
    assert path == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_compile_cache_keeps_the_env_dir(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    assert backend.enable_compile_cache(env, backend.GPU) == str(tmp_path)
    assert calls == []          # JAX reads the variable itself


def test_enable_compile_cache_off_on_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert backend.enable_compile_cache({}, backend.CPU) is None
    assert calls == []


def test_enable_compile_cache_on_gpu_sets_the_fixed_dir(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    path = backend.enable_compile_cache({}, backend.GPU)
    assert calls == [("jax_compilation_cache_dir", path)]
    assert path == backend.compile_cache_dir({})


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        backend.require_gpu()


def test_device_line_names_platform_kind_and_count():
    line = backend.device_line()
    assert re.fullmatch(r"platform=cpu device_kind=\S+ count=8", line)


def test_start_entry_point_logs_the_device_once(capsys):
    backend.start_entry_point()
    err = capsys.readouterr().err
    assert err.count("platform=") == 1 and "count=" in err


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    yield path, f.read()


@pytest.mark.parametrize("pattern", [
    r"interpret\s*=\s*True",        # interpret mode is for tests only
    r"[=!]=\s*[\"']tpu[\"']",       # no TPU branch
    r"pallas\.tpu|pltpu",           # no Mosaic-TPU kernel
    r"def pick_first_compiling|def \w+_candidates\(",  # no selection
                                    # by a failed compile
])
def test_package_has_no(pattern):
    hits = [p for p, src in _sources() if re.search(pattern, src)]
    assert hits == [], hits
