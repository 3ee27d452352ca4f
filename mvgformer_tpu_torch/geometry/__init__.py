"""Geometry: cameras, affine crop transforms, undistortion, DLT.

All float32 tensor functions, batched over leading dims; counterparts of
`mvgformer_tpu.geometry` with the same signatures and conventions.
"""
