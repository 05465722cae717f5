"""Host plugin pieces: the spread defaults the feature extraction reads and
the topology placement plugin the gang planner calls."""
