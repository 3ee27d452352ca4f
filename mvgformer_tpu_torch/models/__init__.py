"""Model layer: backbone, DQ decoder, MVGFormer top model."""
