"""The index and its shortcut view: hashing, extendible hashing, rewiring,
Shortcut-EH."""
