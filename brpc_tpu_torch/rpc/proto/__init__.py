"""proto — the tensor lane's messages, encoded without protobuf (wire.py)."""
