"""Distribution across processes: the (data, cv) layout and the eval work queue."""
