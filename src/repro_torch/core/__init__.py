"""Host-side helpers the port keeps its own copies of (numpy only)."""
