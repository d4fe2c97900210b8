"""Native components of the port (C++ with a C ABI, loaded over ctypes)."""
