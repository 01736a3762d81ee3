"""Physics models of the port."""
