# Launchers: the serving CLI.
