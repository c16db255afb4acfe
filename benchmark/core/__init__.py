"""The harness's own pieces: the manifest, the traffic generator, seeded
weights, the yardstick's arithmetic, the trace reader and the result."""
