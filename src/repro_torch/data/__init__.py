"""Input pipelines: `synthetic` (the counter-based synthetic token
stream, numpy only)."""
