"""Core domain: shared types, constants and pure number-theory math."""
