"""CLI entry points (reference argv contracts)."""
