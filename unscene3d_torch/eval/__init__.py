"""Host-side evaluation code of the port (numpy and scipy only)."""
