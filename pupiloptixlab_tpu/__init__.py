"""pupiloptixlab_tpu — a JAX real-time path-tracing framework.

A from-scratch JAX/XLA rebuild of the capabilities of PupilOptixLab:
mitsuba3-style XML scenes, a world/resource system, a progressive path
tracer with NEE + balance-heuristic MIS, seven BSDFs, per-triangle area
lights, environment-map importance sampling, AOVs, a denoiser hook and an
interactive system/pass runtime. It runs on NVIDIA GPUs (measured on an
H100) and, for tests, on the CPU.

Where the reference leans on NVIDIA-only libraries (OptiX accel
structures, SBT dispatch, CUDA textures, DX12 display):

* scene data is flattened to static-shape structure-of-arrays jnp buffers,
* the render loop is a single jit-compiled wavefront program
  (generate -> intersect -> shade -> NEE shadow -> accumulate),
* material dispatch is branchless masked evaluation over a dense
  material table (replaces optixDirectCall / SBT),
* ray traversal walks an 8-wide BVH per ray: a CUDA kernel called
  through jax.ffi on the GPU, a plain-JAX walk elsewhere,
* multi-device scaling shards pixels/samples over a jax.sharding.Mesh.
"""

__version__ = "0.1.0"

from pupiloptixlab_tpu.scene.scene import Scene, load_scene  # noqa: F401
