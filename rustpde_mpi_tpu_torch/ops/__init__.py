"""Host operator builders, the fused kernels' wrappers and their build."""
