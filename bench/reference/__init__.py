"""Plain float32 references of the benchmark's configurations, one module
a ``model_type`` (its ``spec(conf)`` and the model's functions)."""
