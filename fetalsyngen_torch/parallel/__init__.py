"""Host-to-device input stream of the generator, and batch sharding over
processes."""
