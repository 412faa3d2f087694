"""Host-driven pipeline driver of the port."""
