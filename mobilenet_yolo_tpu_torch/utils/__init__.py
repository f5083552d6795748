"""Host-side helpers of the port (tracing and timing, drawing detections,
the training meters, ``log.txt`` logger and TensorBoard event writer)."""
