"""The port's native host runtime (``native``: ctypes bindings of
``batcher.cpp``)."""
