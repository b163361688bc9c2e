"""The golden NumPy oracle of the port (`akaze.extract`, `matching.match`):
independent of the port's torch code and of JAX, pinned by the checked-in
snapshots."""
