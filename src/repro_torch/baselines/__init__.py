"""Reference algorithms the accelerated paths are checked against."""
