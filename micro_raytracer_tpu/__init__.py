"""micro_raytracer_tpu: a differentiable path-tracing framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the
``micro-raytracer`` Rust microservice (scene JSON -> path-traced image over
CLI or HTTP), redesigned for accelerators: scenes compile to padded SoA device arrays,
the bounce loop is a fixed-depth ``lax.scan`` wavefront over ray batches,
pixel tiles shard over a device mesh via ``shard_map``, and per-pixel
radiance is differentiable w.r.t. materials, lights, sky, and object
transforms.
"""

from .models.schema import RenderConfig, SceneConfig, FrameConfig  # noqa: F401
from .models.compiler import compile_scene, compile_camera  # noqa: F401
from .models.render import Renderer, render_image  # noqa: F401
from .models.tracer import trace_radiance  # noqa: F401

__version__ = "0.1.0"
