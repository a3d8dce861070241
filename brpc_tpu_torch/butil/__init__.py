"""butil — host utilities the tensor lane needs (IOBuf)."""
