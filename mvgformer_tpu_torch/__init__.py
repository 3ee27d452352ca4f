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

    tools      -- the probes of `tools/probes/` that hold Pallas kernels, on
                  the card (tools.probes)

The package imports torch and never jax, flax or anything of the JAX
package. Its config tree (`config.py`) is its own copy of
`mvgformer_tpu/config.py`, so both read the same YAML files and key names.
Entry points (`MVGFormer`, `make_batch`, `build_layer1_window_plan`, the
probes' `main`) run on the card unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
