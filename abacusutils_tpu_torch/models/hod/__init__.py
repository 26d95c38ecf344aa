"""HOD occupation shapes and population markers."""
