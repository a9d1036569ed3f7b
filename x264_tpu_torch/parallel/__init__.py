"""Frames split over devices: the slice-band mesh (``sliced``)."""
