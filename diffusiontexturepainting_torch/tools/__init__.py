"""Entry points of the port that are not the server: A/B scripts run as
`python -m diffusiontexturepainting_torch.tools.<name>`."""
