"""Device selection and JAX-checkpoint interop."""
