"""The ChAdaViT backbone and its checkpoint import."""
