"""Forward+reverse streamtracing and the outlet profile."""
