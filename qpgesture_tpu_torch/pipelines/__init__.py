"""Host pipelines of the port: wav ingestion and the database-builder
helpers that the raw-wav ``generate`` path needs."""
