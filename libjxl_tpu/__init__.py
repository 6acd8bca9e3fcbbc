"""libjxl_tpu — a JAX-native JPEG XL (ISO/IEC 18181) codec framework.

A from-scratch reimplementation of the capabilities of libjxl
(reference v0.12.0-dev) built around JAX/XLA device programs:

- pixel math (DCT zoo, XYB, Gaborish/EPF restoration, quantization,
  chroma-from-luma, adaptive-quant heuristics, Butteraugli) runs as
  jitted JAX/XLA programs over the image's block and group grids, on a
  GPU when one is present;
- the group grid is the shard axis: multi-device scaling uses
  jax.sharding.Mesh + shard_map with ppermute halo exchanges where the
  reference used a fork-join thread pool (lib/jxl/base/data_parallel.h);
- bitstream/entropy assembly (rANS, prefix codes, headers, container)
  runs vectorized on host, per-group streams being embarrassingly
  parallel by format design.

Layer map mirrors SURVEY.md section 1:
  base/     L0 status & misc
  io/       L2-L3 bit I/O, field bundles, headers, TOC, container
  entropy/  L4 rANS + prefix + hybrid-uint + clustering
  ops/      L5 transforms & pixel math (JAX)
  vardct/   L6a lossy frame codec
  modular/  L6b lossless codec
  render/   L7 decoder restoration pipeline
  parallel/ device-mesh sharding & halo exchange
  api/      L8 encoder/decoder state machines
  extras/   L9 external-format I/O
  tools/    L11 CLIs & benchmarks
"""

__version__ = "0.1.0"


def _configure_compile_cache():
    """Persistent XLA compilation cache. JAX_COMPILATION_CACHE_DIR wins
    when set (JAX reads it itself); otherwise the cache lives at one
    fixed path inside the checkout, so every process of this checkout
    shares it. Works whether or not jax was imported first."""
    import os
    import sys

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")
    if "jax" in sys.modules:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)
    else:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = path
        os.environ.setdefault(
            "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "2")


_configure_compile_cache()
