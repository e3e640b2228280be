"""Video I/O: native libav layer with an OpenCV fallback."""
