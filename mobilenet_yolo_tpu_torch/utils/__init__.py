"""Host-side helpers of the port (tracing and timing, drawing detections)."""
