"""Model taskpools built on the port's runtime."""
