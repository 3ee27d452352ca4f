"""Ops: multi-scale deformable sampling (plain version and Hopper kernel)
and the ProjAttn module."""
