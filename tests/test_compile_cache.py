"""The persistent compile cache goes where JAX_COMPILATION_CACHE_DIR says,
else to the fixed ``<checkout>/.jax_cache``."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import jax, jax.numpy as jnp
from single_algebra_tpu.utils.cache import enable_compile_cache
d = enable_compile_cache()
print(d)
print(jax.config.jax_compilation_cache_dir)
if {compile}:
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.jit(lambda x: jnp.sin(x) * 3 + 1)(jnp.arange(7.0)).block_until_ready()
"""


def _run(env_dir, compile_):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(compile=compile_)],
        env=env, cwd=ROOT, capture_output=True, text=True, check=True,
        timeout=120,
    )
    return out.stdout.split()


def test_cache_dir_follows_env(tmp_path):
    d = str(tmp_path / "xla_cache")
    chosen, configured = _run(d, True)
    assert chosen == d and configured == d
    assert os.listdir(d), "nothing was cached in the env directory"


def test_cache_dir_defaults_to_checkout():
    from single_algebra_tpu.utils.cache import DEFAULT_DIR

    assert DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")
    chosen, configured = _run(None, False)
    assert chosen == DEFAULT_DIR and configured == DEFAULT_DIR
