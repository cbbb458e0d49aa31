"""``python -m scgrhc_torch.bench --mode M [--device cuda|cpu] ...``: one JSON
line (:mod:`scgrhc_torch.bench.run`)."""

if __name__ == "__main__":
    from scgrhc_torch.bench.run import main

    main()
