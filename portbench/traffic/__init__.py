"""The traffic kinds: ``<kind>.py`` is the one generator of every mix
(``<mix>.json``) whose ``kind`` names it."""
