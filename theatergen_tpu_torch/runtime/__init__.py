"""Native runtime pieces: the C++ embedding store bindings."""
