"""The plain reference: a float64 PyTorch path tracer of the configurations
(a sequential closest hit over chunks of rects, spheres and triangles and
over media, every material and texture of the books, a thin-lens camera,
its own threefry, Perlin tables, ``.obj`` and PNG readers, the adaptive
heuristic, the render loss with its gradients by autograd, and adam).

It imports neither ``jax`` nor the JAX package nor anything of
``another_raytracer_tpu_torch``: it reads the configuration and the input
files the benchmark wrote, and works out every table from them.  Every
function takes the float type it computes in (``torch.float64``; the
control computes in ``torch.bfloat16``) and the device.
"""
