"""Host-side serving runtime."""
