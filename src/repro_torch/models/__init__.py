"""Model zoo: layer-sequential LMs (the dense family so far)."""
