"""Command-line tools of the port: data provisioning, the deployment CLIs
and the measurement scripts."""
