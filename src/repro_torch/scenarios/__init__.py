"""Policy registry and service-time specification (the port's copies)."""
