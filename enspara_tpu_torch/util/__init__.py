"""Device selection, trajectory loading and timing helpers."""
