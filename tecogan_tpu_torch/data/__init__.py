"""Training data of the port: the PNG codec, synthetic scenes and the
scene loader. Imports no JAX and no OpenCV."""
