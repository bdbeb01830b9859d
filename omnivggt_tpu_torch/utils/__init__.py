"""Camera geometry and weight validation."""
