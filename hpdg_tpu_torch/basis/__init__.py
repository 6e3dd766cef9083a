"""Local bases and the hp-DG function-space basis (host-side numpy)."""
