"""Scene-folder loading and image preprocessing (host side)."""
