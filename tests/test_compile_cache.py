"""The program entry points' compile-cache location."""

import os

import jax

from direct_stereo_slam_tpu.utils import compile_cache
from direct_stereo_slam_tpu.utils.compile_cache import (
    ENV_VAR, compilation_cache_dir, setup_compilation_cache)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_environment_variable_wins():
    assert compilation_cache_dir({ENV_VAR: "/some/cache"}) == "/some/cache"


def test_default_is_fixed_path_inside_checkout():
    d = compilation_cache_dir({})
    assert d == compilation_cache_dir({ENV_VAR: ""})
    assert d == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_setup_points_jax_at_the_directory(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(ENV_VAR, str(tmp_path))
    try:
        assert setup_compilation_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert compile_cache.DEFAULT_DIR.startswith(REPO)
