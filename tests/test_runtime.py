"""parallel.runtime: compile-cache placement and the device line."""

import os

import jax

from hic_genome_assembler_tpu.parallel import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    return calls


def test_cache_in_checkout_when_env_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert runtime.compile_cache_dir() == want
    calls = _record_updates(monkeypatch)
    runtime.enable_compile_cache()
    assert ("jax_compilation_cache_dir", want) in calls


def test_env_cache_dir_is_left_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() is None
    calls = _record_updates(monkeypatch)
    runtime.enable_compile_cache()
    assert not [k for k, _v in calls if k == "jax_compilation_cache_dir"]


def test_device_summary_names_platform_kind_count():
    line = runtime.device_summary()
    assert line == "platform=cpu kind=cpu count={}".format(len(jax.devices()))
