"""Host-to-device input stream of the generator."""
