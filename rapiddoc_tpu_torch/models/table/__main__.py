from rapiddoc_tpu_torch.models.cli import main

if __name__ == "__main__":
    main("table")
