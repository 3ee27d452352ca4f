"""MVGFormer in PyTorch and CUDA: the port of `mvgformer_tpu` to one NVIDIA H100.

The JAX package `mvgformer_tpu` is the reference; this package mirrors its
layout so each module's counterpart sits at the same path:

    geometry   -- cameras (projection with distortion), affine crops,
                  iterative undistortion, DLT triangulation (svd/eigh/jacobi)
    ops        -- multi-scale deformable sampling: the plain PyTorch version
                  (ops.sampling) and the hand-written Hopper kernel behind
                  its wrapper (ops.deform_attn); the ProjAttn module
    models     -- PoseResNet backbone, DQ decoder, MVGFormer top model
    data       -- batch dataclasses and synthetic scenes
    core       -- the serving entry point (core.infer.make_eval_step)
    utils      -- flax variables -> this package's state_dict

The package imports torch and never jax or flax. It shares the JAX package's
framework-free config tree (`mvgformer_tpu.config`), so both read the same
YAML files and key names.
"""

__version__ = "0.1.0"
