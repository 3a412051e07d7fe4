"""Device selection, precision settings and the weight carry."""
