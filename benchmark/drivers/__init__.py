"""Traffic drivers: ``<driver>.py`` serves every mix whose ``driver`` names it."""
