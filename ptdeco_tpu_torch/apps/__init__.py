"""The port's trainer applications (counterparts of the repository's ``apps/``)."""
