"""The checks a configuration names, one module each (``"check"``)."""
