"""Core engines of the port: query metadata, plans, sorted indices,
the BiGJoin dataflow and the Delta-BiGJoin region store."""
