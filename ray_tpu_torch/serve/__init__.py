"""The port's serve-layer vocabulary (request priorities and replica
errors); the HTTP and fleet layers are not ported yet."""
