"""Host plugin pieces the wave path's feature extraction reads."""
