"""Device selection and the JAX weights bridge."""
