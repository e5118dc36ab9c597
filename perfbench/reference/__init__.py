"""The plain reference the port is held to."""
