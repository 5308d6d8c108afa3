"""Model stack of the port: the MoE family and the layers it uses."""
