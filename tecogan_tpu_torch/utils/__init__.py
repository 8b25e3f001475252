"""Host-side helpers of the port: console logging, scalar summaries and the
captured CUDA graphs of the inference paths (``cuda_graphs.py``)."""
