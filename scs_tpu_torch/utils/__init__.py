"""Host-side helpers: the native codec of SCS's binary file format."""
