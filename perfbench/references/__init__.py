"""Plain references of the configurations' semantics, one file each."""
