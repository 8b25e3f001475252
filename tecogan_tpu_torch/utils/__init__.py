"""Host-side helpers of the port: console logging and scalar summaries."""
