"""Device selection, epsilon schedules and on-device diagnostics."""
