"""CNN models routed through the engine."""
