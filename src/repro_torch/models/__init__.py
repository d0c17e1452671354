"""Model zoo: layer-sequential LMs (the dense and RWKV6 families so far)."""
