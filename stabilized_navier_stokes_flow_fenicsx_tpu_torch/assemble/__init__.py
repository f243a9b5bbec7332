"""Assembly, the layered operator and its SpMV kernel."""
