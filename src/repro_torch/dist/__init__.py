"""Distribution of the port over a device mesh (``sharding``)."""
