"""Device execution engine: SQL -> plan -> torch execution (ndstpu.engine)."""
