"""Line-search strategies."""
