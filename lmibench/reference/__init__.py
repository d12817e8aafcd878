"""The plain reference of every configuration: the same semantics as the
port's search, in plain PyTorch float32.  It imports nothing of the
port and takes nothing the port made."""
