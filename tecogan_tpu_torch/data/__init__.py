"""Data of the port: the PNG codec, synthetic scenes, the scene loader and
the inference CLI's frame I/O. Imports no JAX and no OpenCV."""
