"""Host-side tools around the snapshots (counterpart of the JAX package's
``tools/``): the XDMF sidecar generator for ParaView (:mod:`.xdmf`)."""
