"""Inlet profiles and the image-channel flow solve."""
