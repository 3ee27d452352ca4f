"""MVGFormer in PyTorch and CUDA: the port of `mvgformer_tpu` to one NVIDIA H100.

The JAX package `mvgformer_tpu` is the reference; this package mirrors its
layout so each module's counterpart sits at the same path:

    geometry   -- cameras (projection with distortion), affine crops,
                  iterative undistortion, DLT triangulation (svd/eigh/jacobi)
    ops        -- multi-scale deformable sampling: the plain PyTorch version
                  (ops.sampling) and the hand-written Hopper kernel behind
                  its wrapper (ops.deform_attn); the ProjAttn module
    models     -- PoseResNet backbone, DQ decoder, MVGFormer top model
    data       -- batch dataclasses, synthetic scenes, the datasets
                  (Panoptic, Shelf, Campus, H36M, synthetic) and the
                  Prefetcher that places their batches on the card
    runtime    -- the native C++ warp + normalization of the input images
    core       -- the serving entry point and the eval loop (core.infer),
                  the training step, criterion, evaluation and pose NMS
    utils      -- checkpoints, logging, the loaders of flax variables and
                  of the original torch repo's checkpoints
    run        -- the CLIs: `python -m mvgformer_tpu_torch.run.train` and
                  `python -m mvgformer_tpu_torch.run.validate`

    tools      -- the probes of `tools/probes/` that hold Pallas kernels, on
                  the card (tools.probes)

The package imports torch and never jax, flax or anything of the JAX
package. Its config tree (`config.py`) is its own copy of
`mvgformer_tpu/config.py`, so both read the same YAML files and key names.
Entry points (`MVGFormer`, `make_batch`, `build_layer1_window_plan`, the
probes' `main`, the CLIs) run on the card unless the caller passes
`device="cpu"` (`--device cpu` to a CLI).
"""

__version__ = "0.1.0"
