"""butil — host utilities: IOBuf, flags, EndPoint, DoublyBufferedData."""
